"""Port parity: the one-process device mesh (parallel/), the mesh engines
and mai_filter_batch_sharded of neural_speech_decoding_tpu_torch against
the port's unsharded engines and the JAX package's meshes, on the CPU.

The port's meshes are the CPU device repeated (`make_mesh(["cpu"] * n)`);
the JAX side runs on the first n of its 8 virtual CPU devices
(tests/conftest.py). Inputs: board-like raw windows from a numpy seed at
an odd batch (11, so that the bucket pads), the shipped LSTM and flagship
checkpoints.

JAX's meshes compile for seconds on the CPU, so the port is held against
JAX's mesh engines where the path is JAX's own: the LSTM engine at every
dp (its logits at dp 8), the flagship at dp 4; the other mesh paths are
held against the port's unsharded engines, which the other test files hold
against JAX's.

Tolerances: a mesh engine against the port's unsharded engine, 1e-6
|delta prob| with equal argmax and guard counts (each window's arithmetic
is the same; only the batch a kernel or matmul sees changes); the port's
mesh engine against JAX's, 1e-4 |delta logit| (the repository's logit
budget) and 1e-5 |delta prob|.
"""

import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.lstm import decoder_apply as jax_decoder_apply
from neural_speech_decoding_tpu.models.lstm import init_decoder_params as jax_init_decoder_params
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch as jax_filter_batch
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch_sharded as jax_filter_sharded
from neural_speech_decoding_tpu.parallel import mesh as jax_mesh_mod
from neural_speech_decoding_tpu.parallel import sharding as jax_sharding
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu.runtime.ensemble import EnsembleEngine as JaxEnsemble
from neural_speech_decoding_tpu_torch.config import DecoderConfig, FilterConfig
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch, mai_filter_batch_sharded
from neural_speech_decoding_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    mesh_axes,
    replicate,
    shard_params_tp,
    sharded_predict_fn,
)
from neural_speech_decoding_tpu_torch.parallel.sharding import _keystr, _tp_spec_for_leaf
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
NPZ3 = CKPT / "lstm3_retrained.npz"
FLAGSHIP = CKPT / "logcov8wd_ens_manifest.json"
T, C = 625, 8
MESH_PROB_TOL = 1e-6
LOGIT_TOL = 1e-4
PROB_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8], window 3 all zero."""
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
    return raw_windows(11, 7)


def cpu_mesh(n: int, tp: int = 1):
    return make_mesh(["cpu"] * n, tp=tp)


def jax_mesh(n: int, tp: int = 1):
    return jax_mesh_mod.make_mesh(jax.devices()[:n], tp=tp)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,tp", [(1, None), (2, None), (6, None), (8, None), (8, 4), (8, 1), (3, 1)])
def test_mesh_axes_match_jax(n, tp):
    assert mesh_axes(n, tp) == jax_mesh_mod.mesh_axes(n, tp)


def test_mesh_axes_and_errors(monkeypatch):
    assert mesh_axes(8) == (4, 2)
    assert mesh_axes(1) == (1, 1)
    assert mesh_axes(8, tp=4) == (2, 4)
    with pytest.raises(ValueError):
        mesh_axes(6, tp=4)
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "tp": 2} == dict(jax_mesh_mod.make_mesh(jax.devices()).shape)
    assert mesh.distinct == (torch.device("cpu"),) and mesh.primary == torch.device("cpu")
    assert mesh.axis_devices("dp") == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_devices("xy")
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one"):
        make_mesh([])
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(["cpu"] * 6, tp=4)
    # no CUDA and no devices: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    for devices in (["cuda:0", "cuda:0"], ["cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices)


def test_mesh_run_order_threads_and_failures():
    """Results come back in task order; shards of one device run in order
    on one worker thread (not the caller's), with the caller's grad mode;
    a failed shard fails the call after every shard has ended."""
    mesh = cpu_mesh(4, tp=1)
    seen = []

    def task(i):
        seen.append((i, threading.current_thread().name, torch.is_grad_enabled()))
        return i * i

    with torch.no_grad():
        out = mesh.run([(torch.device("cpu"), task, (i,)) for i in range(4)])
    assert out == [0, 1, 4, 9]
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert len({s[1] for s in seen}) == 1 and seen[0][1] != threading.current_thread().name
    assert not any(s[2] for s in seen)

    done = []

    def maybe_fail(i):
        done.append(i)
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        mesh.run([(torch.device("cpu"), maybe_fail, (i,)) for i in range(4)])
    assert done == [0, 1, 2, 3]
    # nested: a task that runs tasks runs them inline on its own thread,
    # as often as it likes
    def nested():
        return [mesh.run([(torch.device("cpu"), task, (k,))]) for k in (5, 6)]

    assert mesh.run([(torch.device("cpu"), nested, ())]) == [[[25], [36]]]
    mesh.close()


def test_batch_sharding_and_replicate():
    mesh = cpu_mesh(8, tp=2)
    x = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    shards = batch_sharding(mesh, x)
    assert [s.shape for s in shards] == [(2, 3)] * 4
    assert torch.equal(torch.cat(shards), x)
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        batch_sharding(mesh, x[:7])
    params = jax_load_npz(NPZ3)
    placed = replicate(mesh, params)
    assert list(placed.copies) == [torch.device("cpu")]
    assert torch.equal(placed.row(3)["fc1"]["w"], torch.from_numpy(np.asarray(params["fc1"]["w"])))


# ---------------------------------------------------------------------------
# tensor-parallel placement
# ---------------------------------------------------------------------------
def _keys(path):
    """A JAX key path as plain dict keys and list indices."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_shard_params_tp_matches_jax_placement():
    """Each leaf's spec and slice shape equal the JAX package's placement
    of the same tree on the same (dp, tp) mesh."""
    params = jax_init_decoder_params(jax.random.PRNGKey(0), JaxDecoderConfig())
    theirs = jax_sharding.shard_params_tp(jax_mesh(8, tp=2), params)
    ours = shard_params_tp(cpu_mesh(8, tp=2), params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        keys = _keys(path)
        assert _keystr(keys) == jax.tree_util.keystr(path)
        spec = tuple(leaf.sharding.spec)
        assert _at(ours.specs, keys) == spec + (None,) * (leaf.ndim - len(spec))
        want = {tuple(s.data.shape) for s in leaf.addressable_shards}
        for row in ours.shards:
            for tree in row:
                assert {tuple(_at(tree, keys).shape)} == want
    # the gate matrices really are sliced over tp; the biases stay whole
    assert ours.shards[0][1]["lstm"][0]["w_ih"].shape == (8, 96)
    assert ours.shards[0][1]["lstm"][0]["b"].shape == (192,)
    assert _tp_spec_for_leaf("['fc1']['b']", 1) == ("tp",)
    with pytest.raises(ValueError, match="not divisible by tp=5"):
        shard_params_tp(cpu_mesh(5, tp=5), params)


def test_tp_sharded_forward_matches_replicated():
    """The tp-sliced LSTM gathered on each row computes the replicated
    forward exactly, and matches JAX's tp-sharded forward."""
    cfg = JaxDecoderConfig()
    params = jax_init_decoder_params(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(1).standard_normal((8, 64, 8)).astype(np.float32)
    jm = jax_mesh(8, tp=2)
    placed = jax_sharding.shard_params_tp(jm, params)
    want = np.asarray(jax.jit(lambda p, w: jax_decoder_apply(p, w, cfg))(
        placed, jax.device_put(x, jax_sharding.batch_sharding(jm))))
    mesh = cpu_mesh(8, tp=2)
    fn, tp_placed = sharded_predict_fn(mesh, lambda p, w: decoder_logits(p, w, DecoderConfig()), params, tp_shard=True)
    rep_fn, rep_placed = sharded_predict_fn(mesh, lambda p, w: decoder_logits(p, w, DecoderConfig()), params)
    with torch.no_grad():
        got = fn(tp_placed, x)
        rep = rep_fn(rep_placed, x)
    assert torch.equal(got, rep)
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL
    whole = tp_placed.row(2)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert np.array_equal(np.asarray(leaf), _at(whole, _keys(path)).numpy())


# ---------------------------------------------------------------------------
# the sharded filter
# ---------------------------------------------------------------------------
def test_filter_sharded_matches_unsharded_and_jax(windows):
    x = windows[:8]
    want = mai_filter_batch(x, FilterConfig(precision="fast"), device="cpu")
    for n in (2, 4):
        got = mai_filter_batch_sharded(x, FilterConfig(precision="fast"), mesh=cpu_mesh(n, tp=1))
        assert torch.equal(got, want)
    got_tp = mai_filter_batch_sharded(torch.from_numpy(x), FilterConfig(precision="fast"), mesh=make_mesh(["cpu"] * 8, tp=8), axis="tp")
    assert torch.equal(got_tp, want)
    theirs = np.asarray(jax_filter_sharded(x, JaxFilterConfig(precision="fast"), mesh=jax_mesh(4, tp=1)))
    assert np.abs(want.numpy() - theirs).max() <= 1e-4 * np.abs(theirs).max()
    with pytest.raises(ValueError, match="not divisible"):
        mai_filter_batch_sharded(x[:7], mesh=cpu_mesh(2, tp=1))


# ---------------------------------------------------------------------------
# the mesh engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lstm_base():
    return InferenceEngine(str(NPZ3), device="cpu")


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_lstm_mesh_engine(lstm_base, windows, dp):
    want_p = lstm_base.predict_batch(windows)
    eng = InferenceEngine(str(NPZ3), mesh=cpu_mesh(dp, tp=1))
    assert eng.device == torch.device("cpu") and eng._bucket_padded(11) == 16
    got_p = eng.predict_batch(windows)
    got_l = eng.logits_batch(windows)
    assert np.abs(got_p - want_p).max() <= MESH_PROB_TOL
    np.testing.assert_array_equal(got_p.argmax(1), want_p.argmax(1))
    assert eng.stats == {"windows": 22, "guard_flagged": 0}
    # JAX's mesh engine, and (at dp 8) JAX's logits under its own mesh
    jm = jax_mesh(dp, tp=1)
    theirs_p = JaxEngine(str(NPZ3), mesh=jm).predict_batch(windows)
    assert np.abs(got_p - theirs_p).max() <= PROB_TOL
    if dp != 8:
        return
    fcfg, dcfg = JaxFilterConfig(precision="fast"), JaxDecoderConfig()
    fn, placed = jax_sharding.sharded_predict_fn(
        jm, lambda p, w: jax_decoder_apply(p, jax_filter_batch(w, fcfg), dcfg), jax_load_npz(NPZ3))
    padded = np.concatenate([windows, np.zeros((16 - 11, T, C), np.float32)])
    theirs_l = np.asarray(fn(placed, jax.device_put(padded, jax_sharding.batch_sharding(jm))))[:11]
    assert np.abs(got_l - theirs_l).max() <= LOGIT_TOL


def test_mesh_engine_serving_surface(lstm_base, windows):
    """predict_batch_async pads to a multiple of dp and slices; decode_recording,
    warmup and predict go through the mesh; a failed shard fails the call;
    `device` must be the mesh's primary device."""
    eng = InferenceEngine(str(NPZ3), mesh=cpu_mesh(2, tp=1), donate=True)
    want = lstm_base.predict_batch(windows[:3])
    got = eng.predict_batch_async(torch.from_numpy(windows[:3]))
    assert got.shape == (3, 3) and np.abs(got.numpy() - want).max() <= MESH_PROB_TOL
    eng.warmup((1, 3))
    assert eng.stats == {"windows": 3, "guard_flagged": 0}
    probs, label = eng.predict(windows[0])
    assert probs.shape == (3,) and label in eng.class_names
    signal = windows[:2].reshape(-1, C)  # 1250 samples: 6 windows at a hop of 1 s
    got_r, starts = eng.decode_recording(signal, hop_seconds=1.0)
    want_r, want_starts = lstm_base.decode_recording(signal, hop_seconds=1.0)
    assert np.abs(got_r - want_r).max() <= MESH_PROB_TOL and np.array_equal(starts, want_starts)
    with pytest.raises(ValueError, match="primary"):
        InferenceEngine(str(NPZ3), mesh=cpu_mesh(2, tp=1), device="meta")

    calls = []
    forward = InferenceEngine._forward

    def failing(self, x, device):
        calls.append(x.shape[0])
        if len(calls) == 2:
            raise RuntimeError("shard failed")
        return forward(self, x, device)

    eng._forward = failing.__get__(eng)
    with pytest.raises(RuntimeError, match="shard failed"):
        eng.predict_batch(windows[:4])
    assert calls == [2, 2]


@pytest.fixture(scope="module")
def flagship_base():
    return EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_flagship_mesh_engine(flagship_base, windows, dp):
    flagged = flagship_base.stats["guard_flagged"]
    want_p = flagship_base.predict_batch(windows)
    want_l = flagship_base.logits_batch(windows)
    flagged = flagship_base.stats["guard_flagged"] - flagged
    eng = EnsembleEngine.from_manifest(str(FLAGSHIP), mesh=cpu_mesh(dp, tp=1))
    got_p, got_l = eng.predict_batch(windows), eng.logits_batch(windows)
    assert got_l.shape == (5, 11, 3)
    assert np.abs(got_p - want_p).max() <= MESH_PROB_TOL
    assert np.abs(got_l - want_l).max() <= MESH_PROB_TOL
    np.testing.assert_array_equal(got_p.argmax(1), want_p.argmax(1))
    assert eng.stats == {"windows": 22, "guard_flagged": flagged}
    if dp != 4:  # JAX's flagship compiles for about 7 s a mesh on the CPU
        return
    theirs = JaxEnsemble.from_manifest(str(FLAGSHIP), mesh=jax_mesh(dp, tp=1))
    theirs_p = theirs.predict_batch(windows)
    assert np.abs(got_p - theirs_p).max() <= PROB_TOL
    assert flagged == 2 * theirs.stats["guard_flagged"]


def _flagship_members(k):
    manifest = json.loads(FLAGSHIP.read_text())
    paths = [str(CKPT / Path(p).name) for p in manifest["members"]][:k]
    return paths, dict(model="logcov8", model_kw=manifest["config"]["model_kw"])


def test_shard_members_flagship(windows):
    """4 flagship members over a dp2 x tp2 mesh: member shards of 2, the
    features once per dp shard; logits in member order, probabilities and
    guard counts as the unsharded engine's; num_members % tp raises JAX's
    ValueError in both packages."""
    paths, kw = _flagship_members(4)
    base = EnsembleEngine(paths, device="cpu", **kw)
    want_p, want_l = base.predict_batch(windows), base.logits_batch(windows)
    mesh = cpu_mesh(4, tp=2)
    for share in ("auto", "never"):
        eng = EnsembleEngine(paths, mesh=mesh, shard_members=True, share_features=share, **kw)
        assert eng.params["head"]["w"].shape[0] == 4
        assert [g[0].stacked["head"]["w"].shape[0] for g in eng._groups_on.values()] == [2, 2]
        got_p, got_l = eng.predict_batch(windows), eng.logits_batch(windows)
        assert np.abs(got_l - want_l).max() <= MESH_PROB_TOL
        assert np.abs(got_p - want_p).max() <= MESH_PROB_TOL
        assert eng.stats == base.stats
    feats, _ = eng.featurize(mai_filter_batch(windows, FilterConfig(precision="fast"), device="cpu"))
    assert torch.allclose(eng.heads(feats), base.heads(feats), rtol=0, atol=1e-6)
    for make, m in ((lambda **k: EnsembleEngine(**k), mesh), (lambda **k: JaxEnsemble(**k), jax_mesh(4, tp=2))):
        with pytest.raises(ValueError, match=r"divisible by the mesh 'tp' axis \(2\)"):
            make(model_paths=paths[:3], mesh=m, shard_members=True, **kw)


def test_mixed_family_mesh_ensemble(windows):
    """Two flagship members and an EEGNet checkpoint, replicated over a dp4
    mesh: as the unsharded engine (held against JAX's in
    tests/test_torch_ensemble.py)."""
    paths = [str(CKPT / f"logcov8wd_ens_s{i}.npz") for i in range(2)] + [str(CKPT / "eegnet3_best.npz")]
    kw = dict(model="logcov8+eegnet", families=["logcov8", "logcov8", "eegnet"],
              model_kw={"logcov8:whiten": True, "logcov8:dropout": 0.0})
    base = EnsembleEngine(paths, device="cpu", **kw)
    eng = EnsembleEngine(paths, mesh=cpu_mesh(4, tp=1), **kw)
    want = base.predict_batch(windows)
    got = eng.predict_batch(windows)
    assert np.abs(got - want).max() <= MESH_PROB_TOL
    assert np.abs(eng.logits_batch(windows) - base.logits_batch(windows)).max() <= MESH_PROB_TOL
    assert eng.stats == base.stats
    with pytest.raises(ValueError, match="turbo/shard_members"):
        EnsembleEngine(paths, mesh=cpu_mesh(4, tp=2), shard_members=True, **kw)


def test_lstm_turbo_ensemble(windows):
    """turbo on a single-family LSTM ensemble: the bfloat16 recurrence, as
    InferenceEngine's turbo serves it (held against JAX's in
    tests/test_torch_engine.py)."""
    paths = [str(NPZ3)] * 2
    turbo = EnsembleEngine(paths, model="lstm", turbo=True, mesh=cpu_mesh(2, tp=1))
    assert turbo.config.decoder.recurrence_dtype == "bfloat16"
    single = InferenceEngine(str(NPZ3), turbo=True, device="cpu")
    x = windows[:4]
    np.testing.assert_allclose(turbo.predict_batch(x), single.predict_batch(x), rtol=0, atol=MESH_PROB_TOL)
