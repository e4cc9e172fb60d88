"""The port's model-evaluation and fidelity tools and its quickstart, on
the CPU: tools/eval_models.py and tools/fidelity_report.py held against
the JAX package's, and the quickstart end to end.

The trials are the port's synthetic 3-class trial CSVs
(`io.dataset.write_synthetic_trials`), with copies of some of them under
the "yes" and "no" prefixes so that the 5-class part runs too. JAX's
eval_models reads its trials from $NSD_DATA_DIR and its reference
checkpoint from the module attribute `tools.eval_models.REFERENCE_CKPT`,
which the tests point at a .pth written by the JAX package's own writer
from checkpoints/lstm3_retrained.npz. The golden dump of the fidelity
report is written in the test's temporary directory from the JAX
package's float64 filter and its LSTM.

Tolerances: each held-out accuracy within one window of JAX's (the same
filtered windows; logits agree to about 1e-6, so only a tie could move
one); the float64 reference filter within 1e-6 of each window's max
|output| of JAX's mai_filter at precision "highest" under x64; the
fidelity f64 and fast f32 modes within 1e-4 |delta logit| of the golden
dump (the logit budget) and with equal argmax; turbo bf16 within 2.6e-1
(JAX's documented turbo-vs-f32 figure, config.py:71-76).
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tools.eval_models as jax_eval_models
from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.lstm import decoder_apply as jax_decoder_apply
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch as jax_mai_filter_batch
from neural_speech_decoding_tpu_torch import quickstart
from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials, write_synthetic_trials
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.tools import eval_models, fidelity_report

REPO = Path(__file__).resolve().parents[1]
NPZ3 = REPO / "checkpoints" / "lstm3_retrained.npz"
LOGIT_TOL = 1e-4
TURBO_LOGIT_TOL = 2.6e-1
FILTER_REL_TOL = 1e-6
CHECKPOINTS = [(n, f) for n, f in eval_models.THREE_CLASS + eval_models.FIVE_CLASS
               if (eval_models.CHECKPOINTS / f).is_file()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Trials of five classes (each food and water trial copied under
    "yes" and "no"), and the reference .pth."""
    root = tmp_path_factory.mktemp("eval_tools")
    trials = write_synthetic_trials(root / "trials", 6, seed=1)
    for src, prefix in (("food", "yes"), ("water", "no")):
        for f in sorted(trials.glob(f"{src}_*.csv")):
            shutil.copy(f, trials / f.name.replace(src, prefix, 1))
    pth = root / "reference.pth"
    save_torch_checkpoint(pth, decoder_params_to_torch_state(jax_load_npz(NPZ3)))
    return {"root": root, "trials": trials, "reference": str(pth)}


@pytest.mark.parametrize("name,file", CHECKPOINTS, ids=[f for _, f in CHECKPOINTS])
def test_evaluate_matches_jax(env, name, file):
    """evaluate() against JAX's on the same fast-filtered windows."""
    prefixes = FIVE_CLASS_PREFIXES if name.endswith("5") else None
    ds = load_trials(env["trials"], **({"class_prefixes": prefixes} if prefixes else {}))
    x = mai_filter_batch(ds.windows, FilterConfig(precision="fast"), device="cpu").numpy()
    path = eval_models.CHECKPOINTS / file
    got = eval_models.evaluate(name, load_params_npz(path), x, ds.labels, device="cpu")
    want = jax_eval_models.evaluate(name, jax_load_npz(path), x, ds.labels)
    assert 0.0 <= got <= 1.0 and abs(got - want) <= 1.0 / len(ds.labels)


def test_eval_models_matches_jax_tool(env, tmp_path, monkeypatch, capsys):
    """The port's CLI against the JAX tool's main on the same trials and
    reference: the same rows (5-class ones included), each accuracy
    within one window."""
    monkeypatch.setenv("NSD_DATA_DIR", str(env["trials"]))
    monkeypatch.setattr(jax_eval_models, "REFERENCE_CKPT", env["reference"])
    want_json, got_json = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["eval_models", "--json", str(want_json)])
    jax_eval_models.main()
    got = eval_models.main(["--reference", env["reference"], "--json", str(got_json), "--device", "cpu"])
    want = json.loads(want_json.read_text())
    assert json.loads(got_json.read_text()) == got
    assert list(got) == list(want) and eval_models.REFERENCE_KEY in got
    assert any("5-class" in k for k in got)
    _, val5 = load_trials(env["trials"], class_prefixes=FIVE_CLASS_PREFIXES).split(0.2, seed=0)
    for k in want:
        assert abs(got[k] - want[k]) <= 1.0 / len(val5.labels), k
    assert "val_acc" in capsys.readouterr().out


def test_eval_models_three_class_data(tmp_path):
    """Without a trial of each 5-class prefix only the 3-class rows run,
    and without --reference there is no reference row."""
    trials = write_synthetic_trials(tmp_path / "t", 4, seed=2)
    got = eval_models.evaluate_all(trials, device="cpu")
    assert list(got) == [f"{n} ({f})" for n, f in eval_models.THREE_CLASS if (eval_models.CHECKPOINTS / f).is_file()]
    assert all(0.0 <= v <= 1.0 for v in got.values())


def test_reference_filter_matches_jax_highest(env):
    ds = load_trials(env["trials"])
    w = ds.windows[:4]
    got = fidelity_report.reference_filter(w)
    want = np.asarray(jax_mai_filter_batch(w, JaxFilterConfig(precision="highest")))
    assert got.dtype == np.float32 and got.shape == w.shape
    for g, h in zip(got, want):
        assert np.abs(g - h).max() <= FILTER_REL_TOL * np.abs(h).max()


@pytest.fixture(scope="module")
def golden(env):
    """The golden dump from the JAX package (float64 filter under x64, the
    LSTM), and the golden filtered windows from the port's tool."""
    ds = load_trials(env["trials"], class_prefixes=FIVE_CLASS_PREFIXES)
    params = jax_load_npz(NPZ3)
    logits = np.asarray(jax_decoder_apply(
        params, jax_mai_filter_batch(ds.windows, JaxFilterConfig(precision="highest")), JaxDecoderConfig()))
    probs = np.asarray(jax.nn.softmax(logits, -1))
    out = {"probs": env["root"] / "golden_probs.npz", "filtered": env["root"] / "golden_filtered.npz"}
    np.savez(out["probs"], files=np.asarray(ds.files), logits=logits.astype(np.float32),
             probs=probs.astype(np.float32))
    fidelity_report.main(["--write-filtered", "--out", str(out["filtered"]), "--data-dir", str(env["trials"])])
    return out


def test_fidelity_mode_table(env, golden, tmp_path):
    out = tmp_path / "report.json"
    report = fidelity_report.main([
        "--checkpoint", env["reference"], "--golden", str(golden["probs"]), "--golden-filtered",
        str(golden["filtered"]), "--data-dir", str(env["trials"]), "--stages", "--json", str(out), "--device", "cpu",
    ])
    assert json.loads(out.read_text()) == report
    assert report["platform"] == "cpu" and report["trials"] == 30
    modes = report["modes"]
    assert list(modes) == ["fidelity f64", "fast f32", "turbo bf16"]
    for name in ("fidelity f64", "fast f32"):
        assert modes[name]["max_dlogit"] <= LOGIT_TOL and modes[name]["argmax_agreement"] == 1.0
        assert modes[name]["model_only_max_dlogit"] <= LOGIT_TOL
    assert modes["turbo bf16"]["max_dlogit"] <= TURBO_LOGIT_TOL
    assert 0.0 <= modes["turbo bf16"]["argmax_agreement"] <= 1.0
    # the filter stage: the float64 mode against the float64 reference filter
    # within the filter tolerance; the model-only stage is the same decoder
    # on the same windows in both float32 modes
    with np.load(golden["filtered"]) as z:
        scale = float(np.abs(z["filtered"]).max())
    assert modes["fidelity f64"]["filter_max_delta"] <= FILTER_REL_TOL * scale
    assert modes["fidelity f64"]["model_only_max_dlogit"] == modes["fast f32"]["model_only_max_dlogit"]


def test_fidelity_report_golden_must_match_the_trials(env, golden, tmp_path):
    with np.load(golden["probs"]) as z:
        body = {k: z[k] for k in z.files}
    body["files"] = body["files"][::-1]
    bad = tmp_path / "bad.npz"
    np.savez(bad, **body)
    with pytest.raises(ValueError, match="its files are not the trials'"):
        fidelity_report.fidelity_report(env["reference"], env["trials"], golden=bad, device="cpu")


def test_write_filtered_needs_out_and_leaves_golden(env, capsys):
    digests = {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in (REPO / "tests" / "golden").glob("*.npz")}
    with pytest.raises(SystemExit):
        fidelity_report.main(["--write-filtered", "--data-dir", str(env["trials"])])
    with pytest.raises(SystemExit):
        fidelity_report.main(["--data-dir", str(env["trials"]), "--device", "cpu"])  # no --checkpoint
    assert "--out" in capsys.readouterr().err
    assert digests == {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                       for p in (REPO / "tests" / "golden").glob("*.npz")}


def test_quickstart_end_to_end(monkeypatch, capsys):
    """No --data-dir and no $NSD_DATA_DIR: synthetic trials in a
    temporary directory, every step on the CPU."""
    monkeypatch.delenv("NSD_DATA_DIR", raising=False)
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "synthetic trials" in text and "device: cpu" in text
    assert out["run_trials"].trials == 5 and abs(float(out["run_trials"].avg_probs.sum()) - 1.0) <= 1e-5
    assert out["stream_predictions"] == 5 and out["recording_windows"] == 11
    assert 0.0 <= out["batch_accuracy"] <= 1.0 and 0.0 <= out["ensemble_accuracy"] <= 1.0
    assert np.isfinite(out["filter_metrics"]["impact_channel"]["artifact_variance_reduction_pct"])


def test_tools_without_cuda_raise(env, monkeypatch, tmp_path):
    """No CUDA and no device named: each entry point raises, and nothing
    is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 625, 8), np.float32)
    calls = [
        lambda: eval_models.evaluate("lstm", load_params_npz(NPZ3), x, np.zeros(2)),
        lambda: eval_models.evaluate_all(env["trials"]),
        lambda: eval_models.main(["--data-dir", str(env["trials"]), "--json", str(tmp_path / "e.json")]),
        lambda: fidelity_report.fidelity_report(env["reference"], env["trials"]),
        lambda: fidelity_report.main(["--checkpoint", env["reference"], "--data-dir", str(env["trials"]),
                                      "--json", str(tmp_path / "f.json")]),
        lambda: quickstart.main(["--data-dir", str(env["trials"])]),
        lambda: quickstart.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not list(tmp_path.iterdir())
