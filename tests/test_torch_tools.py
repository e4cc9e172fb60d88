"""The port's evaluation tools held against the JAX package's on the CPU:
crossval, session_eval, fit_ensemble and stream_soak.

The trials are the port's synthetic 3-class trial CSVs
(`io.dataset.write_synthetic_trials`: each class its own channel mixing
of a shared source model), written to a temporary directory and read
through $NSD_DATA_DIR. JAX's crossval reads its reference checkpoint
from the module attribute `tools.crossval.REFERENCE_CKPT`, which the tests
point at a .pth written by the JAX package's own writer from
checkpoints/lstm3_retrained.npz; the port is given the same file through
`reference=`.

Tolerances: folds, inner splits and augmentation labels exactly equal;
probabilities within 1e-5; the reference column's accuracies equal;
session accuracies equal (the draws are the same numpy draws).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.crossval as jax_crossval
import tools.session_eval as jax_session_eval
import tools.stream_soak as jax_stream_soak
from neural_speech_decoding_tpu.io.checkpoint import load_decoder_params as jax_load_decoder_params
from neural_speech_decoding_tpu.io.dataset import load_trials as jax_load_trials
from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch as jax_mai_filter_batch
from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu.runtime.ensemble import EnsembleEngine as JaxEnsemble
from neural_speech_decoding_tpu.train import augment as jax_augment
from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials, write_synthetic_trials
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
from neural_speech_decoding_tpu_torch.tools import crossval, fit_ensemble, session_eval, stream_soak

REPO = Path(__file__).resolve().parents[1]
T = 625
PROB_TOL = 1e-5
FLAGSHIP_KW = {"whiten": True, "dropout": 0.0}
# lr 0: every member keeps its (shared) initial parameters, so the two
# frameworks' held-out probabilities are comparable; 20 trials a class so
# that the inner training split and its augmented copies fill a batch and
# each epoch takes a step
CV_KW = dict(model="logcov8", folds=2, epochs=2, seeds=2, lr=0.0, model_kw=FLAGSHIP_KW, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The trial directory as $NSD_DATA_DIR, and the reference .pth as JAX
    crossval's REFERENCE_CKPT, for the whole module."""
    root = tmp_path_factory.mktemp("tools")
    trials = write_synthetic_trials(root / "trials", 20, seed=0)
    pth = root / "reference.pth"
    save_torch_checkpoint(pth, decoder_params_to_torch_state(jax_load_npz(REPO / "checkpoints/lstm3_retrained.npz")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSD_DATA_DIR", str(trials))
        mp.setattr(jax_crossval, "REFERENCE_CKPT", str(pth))
        yield {"root": root, "trials": trials, "reference": str(pth)}


def jax_init(family: str, member_seed: int):
    """JAX crossval's init of a member: PRNGKey(seed), split, spec.init."""
    _, k = jax.random.split(jax.random.PRNGKey(member_seed))
    return jax.tree_util.tree_map(np.asarray, jax_get_model(family, **FLAGSHIP_KW).init(k))


def _jax_initialised(mp):
    """Make the port's crossval start each member from JAX's initial
    parameters: the member's generator is seeded with the member's seed,
    which the patched spec's init reads back."""
    port_get_model = crossval.get_model

    def get_model_jax_init(name, **kw):
        spec = port_get_model(name, **kw)

        def init(generator):
            return params_from_jax(jax_init(name, generator.initial_seed()), generator.device)

        return dataclasses.replace(spec, init=init)

    mp.setattr(crossval, "get_model", get_model_jax_init)


def _recorded(mp, module, name):
    """Wrap module.name so that every call's result is kept."""
    calls = []
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out)
        return out

    mp.setattr(module, name, wrapper)
    return calls


@pytest.fixture(scope="module")
def runs(env):
    """JAX's crossval and the port's on the same trials, with their draws."""
    with pytest.MonkeyPatch.context() as mp:
        jax_folds = _recorded(mp, jax_crossval, "stratified_folds")
        jax_aug = _recorded(mp, jax_augment, "augment_batch_np")
        theirs = jax_crossval.run_crossval(**CV_KW)
    with pytest.MonkeyPatch.context() as mp:
        port_folds = _recorded(mp, crossval, "stratified_folds")
        port_aug = _recorded(mp, crossval, "augment_batch_np")
        _jax_initialised(mp)
        ours = crossval.run_crossval(**CV_KW, reference=env["reference"], device="cpu")
    path = env["root"] / "cv_jax.json"
    path.write_text(json.dumps(theirs, indent=2))
    return {"jax": theirs, "port": ours, "jax_json": path,
            "draws": (jax_folds, jax_aug, port_folds, port_aug)}


def structure(tree):
    """Keys, list lengths and leaf kinds of a JSON tree."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [structure(v) for v in tree]
    return "number" if isinstance(tree, (int, float)) and not isinstance(tree, bool) else type(tree).__name__


@pytest.mark.parametrize("k, seed", [(2, 0), (3, 7), (5, 100)])
def test_stratified_folds_match_jax(k, seed):
    labels = np.random.default_rng(seed).integers(0, 3, 61)
    for got, want in zip(crossval.stratified_folds(labels, k, seed), jax_crossval.stratified_folds(labels, k, seed)):
        np.testing.assert_array_equal(got, want)


def test_crossval_draws_match_jax(runs):
    jax_folds, jax_aug, port_folds, port_aug = runs["draws"]
    assert len(port_folds) == len(jax_folds) == 3  # the outer folds, then one inner split a fold
    for got, want in zip(port_folds, jax_folds):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(port_aug) == len(jax_aug) == 4  # one draw a member and fold
    for (xa, ya), (jxa, jya) in zip(port_aug, jax_aug):
        np.testing.assert_array_equal(ya, jya)
        assert xa.shape == jxa.shape and len(xa) > 0
        # the same windows and injections of the two frameworks' filtered data
        assert float(np.abs(xa - jxa).max()) <= 1e-4 * float(np.abs(jxa).max())
    for got, want in zip(runs["port"]["fold_detail"], runs["jax"]["fold_detail"]):
        assert got["y_val"] == want["y_val"] and got["members"] == want["members"]


def test_crossval_json_keys_and_shapes(runs):
    ours, theirs = runs["port"], runs["jax"]
    assert structure(json.loads(json.dumps(ours))) == structure(theirs)
    assert ours["config"] == theirs["config"]
    assert len(ours["fold_detail"][0]["val_features"][0]) == 8 * 36


def test_crossval_reference_column(runs, env):
    ours, theirs = runs["port"], runs["jax"]
    assert ours["reference"] == theirs["reference"]
    assert ours["reference_mean"] == theirs["reference_mean"]
    # the reference's held-out probabilities of each fold
    ds, jds = load_trials(), jax_load_trials()
    filtered = mai_filter_batch(ds.windows, FilterConfig(precision="fast"), device="cpu")
    jfiltered = np.asarray(jax_mai_filter_batch(jds.windows, JaxFilterConfig(precision="fast")))
    ref = crossval.load_reference(env["reference"], torch.device("cpu"))
    jref = jax_load_decoder_params(env["reference"])
    for val_idx in crossval.stratified_folds(ds.labels, CV_KW["folds"], 0):
        with torch.no_grad():
            got = torch.softmax(get_model("lstm").apply(ref, filtered[torch.as_tensor(val_idx)]), -1).numpy()
        want = np.asarray(jax.nn.softmax(jax_get_model("lstm").apply(jref, jfiltered[val_idx], train=False), -1))
        assert float(np.abs(got - want).max()) <= PROB_TOL


def test_crossval_heldout_probs_of_jax_params(runs):
    """JAX's nested parameters (from its JSON, full precision), carried
    across as the port's session_eval reads them, through the port's path (fast filter,
    featurize, head) against JAX's path; and the port's own run, started
    from JAX's initial parameters, against JAX's."""
    ours, theirs = runs["port"], runs["jax"]
    ds = load_trials()
    filtered = mai_filter_batch(ds.windows, FilterConfig(precision="fast"), device="cpu")
    jfiltered = np.asarray(jax_mai_filter_batch(jax_load_trials().windows, JaxFilterConfig(precision="fast")))
    spec, jspec = get_model("logcov8", **FLAGSHIP_KW), jax_get_model("logcov8", **FLAGSHIP_KW)
    folds = crossval.stratified_folds(ds.labels, CV_KW["folds"], 0)
    for val_idx, fd, jfd in zip(folds, ours["fold_detail"], theirs["fold_detail"]):
        for jp, pp in zip(jfd["member_nested_params"], fd["member_nested_params"]):
            params = session_eval.params_from_lists(jp, "cpu")
            with torch.no_grad():
                got = torch.softmax(
                    spec.head_apply(params, spec.featurize(params, filtered[torch.as_tensor(val_idx)])), -1
                ).numpy()
            jparams = {k: ({kk: jnp.asarray(np.asarray(vv, np.float32)) for kk, vv in v.items()}
                           if isinstance(v, dict) else jnp.asarray(np.asarray(v, np.float32))) for k, v in jp.items()}
            want = np.asarray(jax.nn.softmax(jspec.head_apply(jparams, jspec.featurize(jparams, jfiltered[val_idx])), -1))
            assert float(np.abs(got - want).max()) <= PROB_TOL
            # the port's member, from JAX's initial head: its own whitener fit
            w, jw = np.asarray(pp["whitener"]), np.asarray(jp["whitener"])
            assert float(np.abs(w - jw).max()) <= 1e-5 * float(np.abs(jw).max())
        # the JSON's probabilities are rounded to 5 decimals: one rounding
        # step on top of the tolerance
        got, want = np.asarray(fd["member_nested_probs"]), np.asarray(jfd["member_nested_probs"])
        assert float(np.abs(got - want).max()) <= PROB_TOL + 1e-5 + 1e-12
    assert ours["by_protocol"]["nested"]["folds"] == theirs["by_protocol"]["nested"]["folds"]


def test_crossval_without_reference_mixed_families(env):
    """No reference given: its entries are empty. A cross-family run with a
    family trained on windows (EEGNet), class weights, the 'last'
    headline, and real learning steps."""
    out = crossval.run_crossval(
        model="logcov8+eegnet", folds=2, epochs=2, seeds=1, lr=1e-2, protocol="last",
        class_weight="balanced", model_kw={"logcov8:whiten": True, "logcov8:dropout": 0.0},
        verbose=True, device="cpu",
    )
    assert out["reference"] == [] and out["reference_mean"] is None and out["reference_std"] is None
    assert out["ours_mean"] == out["by_protocol"]["last"]["mean"]
    assert out["biased_is_per_member"] is True
    for fd in out["fold_detail"]:
        assert fd["members"] == ["logcov8", "eegnet"]
        assert "val_features" not in fd and "member_nested_params" not in fd
        probs = np.asarray(fd["member_nested_probs"])
        assert probs.shape == (2, len(fd["y_val"]), 3) and np.allclose(probs.sum(-1), 1.0, atol=5e-5)


def test_crossval_cli(env, tmp_path, capsys):
    out = tmp_path / "cv.json"
    crossval.main(["--model", "logcov8", "--folds", "2", "--epochs", "1", "--model-kw", "whiten=true",
                   "--reference", env["reference"], "--json", str(out), "--device", "cpu"])
    summary = json.loads(out.read_text())
    assert summary["config"]["model_kw"] == {"whiten": True} and len(summary["reference"]) == 2
    assert "reference checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("crop", [0.0, 4.0])
def test_session_eval_matches_jax(runs, env, crop):
    theirs = jax_session_eval.evaluate(str(runs["jax_json"]), draws=300, crop_seconds=crop)
    ours = session_eval.evaluate(str(runs["jax_json"]), draws=300, crop_seconds=crop,
                                 reference=env["reference"], device="cpu")
    assert ours == theirs
    assert ours["reference_session"] is not None and ours["session_feature_avg"] is not None
    assert (ours["session_crop"] is not None) == (crop > 0)
    for row in ("session", "per_window", "session_feature_avg"):
        assert all(0.0 <= v <= 1.0 and np.isfinite(v) for v in ours[row]["folds"])


def test_session_eval_without_reference_and_cli(runs, tmp_path, capsys):
    r = session_eval.evaluate(str(runs["jax_json"]), draws=50, device="cpu")
    assert r["reference_session"] is None and r["reference_per_window"] is None
    out = tmp_path / "s.json"
    session_eval.main([str(runs["jax_json"]), "--draws", "50", "--json", str(out), "--device", "cpu"])
    assert json.loads(out.read_text())[0]["session"] == r["session"]
    assert "session (10-window avg)" in capsys.readouterr().out


JAX_MANIFEST_FIELDS = {"model", "members", "families", "config", "serve_with"}  # tools/fit_ensemble.py:150-163
JAX_MANIFEST_CONFIG = {"epochs", "augment", "aug_kinds", "label_smoothing", "lr", "schedule", "base_seed", "model_kw"}


def test_fit_ensemble_serves_in_both_packages(env, tmp_path, capsys):
    manifest = fit_ensemble.fit_ensemble(
        str(tmp_path / "ens"), model="logcov8", seeds=2, epochs=2, model_kw=FLAGSHIP_KW, device="cpu",
    )
    body = json.loads(Path(manifest).read_text())
    assert set(body) == JAX_MANIFEST_FIELDS and set(body["config"]) == JAX_MANIFEST_CONFIG
    assert body["families"] == ["logcov8", "logcov8"] and len(body["members"]) == 2
    assert "[member 2/2]" in capsys.readouterr().out
    windows = load_trials().windows[:16]
    ours = EnsembleEngine.from_manifest(manifest, device="cpu")
    theirs = JaxEnsemble.from_manifest(manifest)
    got, want = ours.predict_batch(windows), theirs.predict_batch(windows)
    assert got.shape == (16, 3) and float(np.abs(got - want).max()) <= PROB_TOL
    # the members share the whitener fitted on the full dataset
    a, b = (jax_load_npz(p)["whitener"] for p in body["members"])
    np.testing.assert_array_equal(a, b)


def test_fit_ensemble_cli_mixed(env, tmp_path):
    fit_ensemble.main(["--model", "logcov8+logcov12", "--seeds", "1", "--epochs", "1", "--out-prefix",
                       str(tmp_path / "mix"), "--model-kw", "whiten=true", "--device", "cpu"])
    body = json.loads((tmp_path / "mix_manifest.json").read_text())
    assert [Path(m).name for m in body["members"]] == ["mix_logcov8_s0.npz", "mix_logcov12_s0.npz"]
    probs = EnsembleEngine.from_manifest(str(tmp_path / "mix_manifest.json"), device="cpu").predict_batch(
        load_trials().windows[:4])
    assert probs.shape == (4, 3) and np.allclose(probs.sum(1), 1.0, atol=1e-5)


def test_stream_soak_matches_jax(env):
    engine = stream_soak.make_engine("flagship", device="cpu")
    manifest = json.loads((REPO / "checkpoints/logcov8w_deploy_manifest.json").read_text())
    jengine = JaxEngine(str(REPO / manifest["members"][0]), model="logcov8", model_kw={"whiten": True})
    preds = []
    report = stream_soak.soak(engine, "flagship", 5, 64.0, 1.0, 5.0, 60.0, on_prediction=preds.append)
    theirs = jax_stream_soak.soak(jengine, "flagship", 2, 64.0, 1.0, 5.0, 60.0)
    assert set(report) == set(theirs) and set(report["latency_ms"]) == set(theirs["latency_ms"])
    assert report["hops_decoded"] == 5 and report["engine_stats"]["windows"] == 5
    assert report["hops_missed_while_busy"] >= 0 and sum(report["label_histogram"].values()) == 5
    # each prediction against the JAX engine on the window at its counter
    stream = np.concatenate(list(load_trials(env["trials"], strict_shape=False).windows)).astype(np.float64)
    idx = (np.asarray([p.counter for p in preds])[:, None] - T + 1 + np.arange(T)[None, :]) % stream.shape[0]
    want = jengine.predict_batch(stream[idx].astype(np.float32))
    assert float(np.abs(np.stack([p.probs for p in preds]) - want).max()) <= PROB_TOL


def test_stream_soak_cli(env, tmp_path, capsys):
    out = tmp_path / "soak.json"
    stream_soak.main(["--hops", "2", "--speed", "64", "--engines", "flagship", "--json", str(out),
                      "--device", "cpu"])
    body = json.loads(out.read_text())
    assert set(body) == {"tunnel_rtt_p50_ms", "device", "rows"} and body["device"] == "cpu"
    assert body["rows"][0]["hops_decoded"] == 2 and '"engine": "flagship"' in capsys.readouterr().out


def test_tools_without_cuda_raise(env, runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = [
        lambda: crossval.run_crossval(**CV_KW),
        lambda: crossval.main(["--model", "logcov8", "--folds", "2", "--epochs", "1"]),
        lambda: session_eval.evaluate(str(runs["jax_json"])),
        lambda: session_eval.main([str(runs["jax_json"])]),
        lambda: fit_ensemble.fit_ensemble(str(tmp_path / "e"), model="logcov8", seeds=1, epochs=1),
        lambda: fit_ensemble.main(["--model", "logcov8", "--out-prefix", str(tmp_path / "e")]),
        lambda: stream_soak.make_engine("flagship"),
        lambda: stream_soak.main(["--hops", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not list(tmp_path.iterdir())  # nothing was written
