"""Port parity: EnsembleEngine (runtime/ensemble.py), the logcov families of
InferenceEngine, and the tester CLI of neural_speech_decoding_tpu_torch
against the JAX package's engines on the CPU.

The flagship is the whitened logcov8 seed ensemble that
checkpoints/logcov8wd_ens_manifest.json declares: 5 members, one shared
feature extraction (their whiteners are bit-identical), 5 heads, mean of
the member softmaxes.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from jax import random as jax_random

from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxInferenceEngine
from neural_speech_decoding_tpu.runtime.ensemble import EnsembleEngine as JaxEnsembleEngine
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.runtime import tester
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import (
    EnsembleEngine,
    _combine_soft,
    _identical_whiteners,
    stack_params,
)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
FLAGSHIP = CKPT / "logcov8wd_ens_manifest.json"
T, C = 625, 8
PROB_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8] (runtime/board.SyntheticBoard's
    sinusoids, slow modulation and noise), with window 3 all zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    x[3] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def windows():
    return raw_windows(20, 5)  # a non-power-of-two batch: bucket 32


@pytest.fixture(scope="module")
def flagship():
    return EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")


def test_flagship_matches_jax_engine(flagship, windows):
    """The flagship manifest end to end (filter, shared features, 5 heads,
    mean softmax) on 20 raw windows, one all zero: probabilities within
    1e-5, equal argmax, equal stats."""
    jax_engine = JaxEnsembleEngine.from_manifest(str(FLAGSHIP))
    want = jax_engine.predict_batch(windows)
    assert flagship._shared_featurize and flagship.num_members == 5
    got = flagship.predict_batch(windows)
    assert got.shape == (20, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert flagship.stats == jax_engine.stats == {"windows": 20, "guard_flagged": 0}
    assert flagship.class_names == jax_engine.class_names


def test_flagship_per_member_path_equals_shared(flagship, windows):
    never = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu", share_features="never")
    assert not never._shared_featurize
    np.testing.assert_allclose(
        never.predict_batch(windows), flagship.predict_batch(windows), rtol=0, atol=1e-6
    )
    logits = never.logits_batch(windows[:4])
    assert logits.shape == (5, 4, 3)


def test_median_combine_even_member_count_matches_jax(windows):
    """combine="median" over 4 members: the mean of the two middle
    softmaxes, renormalised, as jnp.median takes it."""
    paths = json.loads(FLAGSHIP.read_text())["members"][:4]
    paths = [str(REPO / p) for p in paths]
    kw = dict(model="logcov8", model_kw={"whiten": True, "dropout": 0.0}, combine="median")
    want = JaxEnsembleEngine(paths, **kw).predict_batch(windows[:8])
    got = EnsembleEngine(paths, device="cpu", **kw).predict_batch(windows[:8])
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_combine_soft_median_and_mean():
    soft = torch.from_numpy(np.random.default_rng(2).dirichlet(np.ones(3), size=(4, 6)).astype(np.float32))
    med = np.median(soft.numpy(), axis=0)
    np.testing.assert_allclose(
        _combine_soft(soft, "median").numpy(), med / med.sum(-1, keepdims=True), rtol=0, atol=1e-7
    )
    np.testing.assert_allclose(_combine_soft(soft[:3], "median").numpy().sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(_combine_soft(soft, "mean").numpy(), soft.numpy().mean(0), atol=1e-7)


def test_stack_params_refusals():
    a = load_params_npz(CKPT / "logcov8wd_ens_s0.npz")
    b = load_params_npz(CKPT / "logcov8_ens_s0.npz")  # no whitener
    c = load_params_npz(CKPT / "logcov8_5_wd_ens_s0.npz")  # 5 classes
    stacked = stack_params([a, a])
    assert stacked["head"]["w"].shape == (2, 288, 3) and stacked["whitener"].shape == (2, 8, 8, 8)
    with pytest.raises(ValueError, match="structure"):
        stack_params([a, b])
    with pytest.raises(ValueError, match="leaf shapes"):
        stack_params([a, c])
    with pytest.raises(ValueError, match="at least one"):
        stack_params([])
    assert _identical_whiteners([a, a]) and _identical_whiteners([b, b])
    assert not _identical_whiteners([a, b])


def test_from_manifest_paths_and_duplicates(tmp_path):
    """Member paths resolve relative to the manifest's directory, then by
    basename next to it; members that collapse to one path are refused."""
    names = ["logcov8wd_ens_s0.npz", "logcov8wd_ens_s1.npz"]
    (tmp_path / "sub").mkdir()
    shutil.copy(CKPT / names[0], tmp_path / "sub" / names[0])
    shutil.copy(CKPT / names[1], tmp_path / names[1])
    manifest = {
        "model": "logcov8",
        "members": [f"sub/{names[0]}", f"checkpoints/{names[1]}"],
        "config": {"model_kw": {"whiten": True, "dropout": 0.0}},
    }
    path = tmp_path / "m_manifest.json"
    path.write_text(json.dumps(manifest))
    eng = EnsembleEngine.from_manifest(str(path), device="cpu")
    assert eng.num_members == 2 and eng._shared_featurize
    assert eng._spec.config.whiten and eng._spec.config.dropout == 0.0
    manifest["members"] = [f"checkpoints/{names[1]}", names[1]]
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="duplicate"):
        EnsembleEngine.from_manifest(str(path), device="cpu")


def test_ensemble_refusals():
    paths = [str(CKPT / "logcov8wd_ens_s0.npz")] * 2
    with pytest.raises(ValueError, match="combine"):
        EnsembleEngine(paths, model="logcov8", combine="max", device="cpu")
    # mixed-family ensembles raise JAX's ValueErrors, in both packages
    s0, s5 = str(CKPT / "logcov8wd_ens_s0.npz"), str(CKPT / "logcov8_5_wd_ens_s0.npz")
    for make in (lambda *a, **k: EnsembleEngine(*a, device="cpu", **k), JaxEnsembleEngine):
        with pytest.raises(ValueError, match="do not split evenly"):
            make([s0] * 3, model="logcov8+logcov12")
        with pytest.raises(ValueError, match="disagree on class names"):
            make([s0, s5], model="logcov8+logcov8_5")
        with pytest.raises(ValueError, match="must parallel"):
            make(paths, model="logcov8", families=["logcov8"])
        for kw in ({"turbo": True}, {"shard_members": True}):
            with pytest.raises(ValueError, match="turbo/shard_members"):
                make(paths, model="logcov8+logcov12", **kw)
    # one family: turbo, mesh and shard_members serve (turbo has no effect
    # on logcov; shard_members without a mesh is ignored, as in JAX)
    from neural_speech_decoding_tpu_torch.parallel import make_mesh

    x = raw_windows(5, 2)
    want = EnsembleEngine(paths, model="logcov8", device="cpu").predict_batch(x)
    mesh = make_mesh(["cpu"] * 4, tp=2)
    for kw in ({"turbo": True}, {"mesh": mesh}, {"shard_members": True}, {"mesh": mesh, "shard_members": True}):
        eng = EnsembleEngine(paths, model="logcov8", device=None if "mesh" in kw else "cpu", **kw)
        assert np.abs(eng.predict_batch(x) - want).max() <= 1e-6
    with pytest.raises(ValueError, match="model_paths or params_list"):
        EnsembleEngine(model="logcov8", device="cpu")


def test_lstm_member_ensemble_matches_jax(windows):
    """LSTM members: the filter once, one decoder per member, mean softmax
    (and the reference "None" class name from a manifest)."""
    paths = [str(CKPT / "lstm3_retrained.npz")] * 2
    want = JaxEnsembleEngine(paths, model="lstm").predict_batch(windows[:3])
    eng = EnsembleEngine(paths, model="lstm", device="cpu")
    got = eng.predict_batch(windows[:3])
    assert np.abs(got - want).max() <= PROB_TOL
    assert eng.stats == {"windows": 3, "guard_flagged": 0}


def test_whitened_inference_engine_matches_jax(windows):
    """One whitened logcov checkpoint through InferenceEngine with
    model_kw={"whiten": True}: probabilities within 1e-5, equal stats."""
    path = str(CKPT / "logcov8w_deploy_s0.npz")
    jax_engine = JaxInferenceEngine(path, model="logcov8", model_kw={"whiten": True})
    want = jax_engine.predict_batch(windows)
    eng = InferenceEngine(path, model="logcov8", model_kw={"whiten": True}, device="cpu")
    got = eng.predict_batch(windows)
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert eng.stats == jax_engine.stats
    assert eng.class_names == jax_engine.class_names
    with pytest.raises(ValueError, match="LSTM-family"):
        InferenceEngine(str(CKPT / "x.pth"), model="logcov8", device="cpu")


def test_tester_cli_serves_the_manifest(capsys):
    tester.main([
        "--model", str(FLAGSHIP), "--board", "synthetic", "--speed", "64",
        "--trials", "2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "windows/s:" in out and "Averaged over 2 trials" in out


def _jax_init(family: str, seed: int, **cfg_kw):
    from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model

    return jax_get_model(family, **cfg_kw).init(jax_random.PRNGKey(seed))


def _check_same(got, want, eng, jax_engine):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert eng.stats == jax_engine.stats
    assert eng.class_names == jax_engine.class_names


@pytest.mark.parametrize("combine", ["mean", "median"])
def test_mixed_logcov8_logcov12_matches_jax(windows, combine):
    """"logcov8+logcov12" from JAX-init parameters, 2 members each (even
    split, family order; shared features per group): probabilities within
    1e-5, equal argmax and stats; the median sees all 4 members."""
    params = [_jax_init("logcov8", 0), _jax_init("logcov8", 1), _jax_init("logcov12", 2), _jax_init("logcov12", 3)]
    kw = dict(params_list=params, model="logcov8+logcov12", combine=combine)
    jax_engine = JaxEnsembleEngine(**kw)
    eng = EnsembleEngine(device="cpu", **kw)
    assert eng.families == jax_engine.families == ("logcov8",) * 2 + ("logcov12",) * 2
    assert eng._shared_featurize == jax_engine._shared_featurize == (True, True)
    _check_same(eng.predict_batch(windows), jax_engine.predict_batch(windows), eng, jax_engine)
    logits = eng.logits_batch(windows[:4])
    assert logits.shape == (4, 4, 3)
    soft = torch.softmax(torch.from_numpy(logits), dim=-1)
    np.testing.assert_allclose(
        _combine_soft(soft, combine).numpy(), eng.predict_batch(windows[:4]), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("share_features", ["auto", "never"])
def test_mixed_guard_flags_or_over_groups(share_features):
    """"logcov8+tcn" with the logcov members' whitener gain on channel 5 cut
    to 0.18, which fires the guard on 2 of 8 board-like windows (their
    smallest trace-normalised eigenvalues sit 2 % and 22 % under lo, the
    others at least 1.5 % over it): the TCN group has no flags, the OR over
    groups keeps the logcov group's, equal to JAX's, on the shared and the
    per-member path."""
    from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz

    logcov = [jax_load_npz(CKPT / f"logcov8wd_ens_s{i}.npz") for i in (0, 1)]
    cold = logcov[0]["whitener"] * np.where(np.arange(8) == 5, 0.18, 1.0).astype(np.float32)[None, None, :]
    for p in logcov:
        p["whitener"] = cold.astype(np.float32)
    params = logcov + [jax_load_npz(CKPT / "tcn3_best.npz"), jax_load_npz(CKPT / "tcn3_deploy.npz")]
    x = raw_windows(8, 3)
    x[2, :, 5] = 0.002 * np.sin(np.arange(T) * 0.3)
    x[5, :, 1] = 0.0
    kw = dict(params_list=params, model="logcov8+tcn", share_features=share_features,
              model_kw={"logcov8:whiten": True, "logcov8:dropout": 0.0})
    jax_engine = JaxEnsembleEngine(**kw)
    eng = EnsembleEngine(device="cpu", **kw)
    assert eng._shared_featurize == jax_engine._shared_featurize == (share_features == "auto", False)
    _check_same(eng.predict_batch(x), jax_engine.predict_batch(x), eng, jax_engine)
    assert eng.stats == {"windows": 8, "guard_flagged": 2}


SHIPPED_MIX = [f"logcov8wd_ens_s{i}.npz" for i in range(5)] + [
    "tcn3_best.npz", "eegnet3_best.npz", "transformer3_best.npz"
]


def test_mixed_shipped_manifest_matches_jax(tmp_path, windows):
    """The 5 flagship members with tcn3_best, eegnet3_best and
    transformer3_best through a manifest with "families" (per-family
    overrides "logcov8:whiten", "logcov8:dropout"): one filter, the logcov
    group on shared features, 3 single-member groups; probabilities within
    1e-5 of JAX's engine, equal argmax and guard stats."""
    for name in SHIPPED_MIX:
        shutil.copy(CKPT / name, tmp_path / name)
    manifest = {
        "model": "logcov8",
        "members": [f"checkpoints/{n}" for n in SHIPPED_MIX],
        "families": ["logcov8"] * 5 + ["tcn", "eegnet", "transformer"],
        "config": {"model_kw": {"logcov8:whiten": True, "logcov8:dropout": 0.0}},
    }
    path = tmp_path / "mix_manifest.json"
    path.write_text(json.dumps(manifest))
    jax_engine = JaxEnsembleEngine.from_manifest(str(path))
    eng = EnsembleEngine.from_manifest(str(path), device="cpu")
    assert eng.num_members == 8 and eng.families == tuple(manifest["families"])
    assert eng._shared_featurize == (True, False, False, False)
    _check_same(eng.predict_batch(windows), jax_engine.predict_batch(windows), eng, jax_engine)
    assert eng.logits_batch(windows[:2]).shape == (8, 2, 3)


@pytest.mark.parametrize("family, members", [
    ("tcn", ["tcn3_best", "tcn3_deploy"]),
    ("transformer", ["transformer3", "transformer3_best"]),
])
def test_plain_family_ensemble_matches_jax(windows, family, members):
    """A single-family ensemble of a family without guard flags: each
    member's apply, mean softmax, against JAX's vmapped members."""
    paths = [str(CKPT / f"{m}.npz") for m in members]
    jax_engine = JaxEnsembleEngine(paths, model=family)
    eng = EnsembleEngine(paths, model=family, device="cpu")
    _check_same(eng.predict_batch(windows[:8]), jax_engine.predict_batch(windows[:8]), eng, jax_engine)


def test_tester_cli_serves_a_family_checkpoint(capsys):
    tester.main([
        "--model", str(CKPT / "tcn3_deploy.npz"), "--family", "tcn", "--board", "synthetic",
        "--speed", "64", "--trials", "2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "windows/s:" in out and "Averaged over 2 trials" in out
