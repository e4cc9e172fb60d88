"""Port parity: reductions across a mesh (parallel/collective.py) and
data-parallel training (train/loop.py with `mesh=`) of
neural_speech_decoding_tpu_torch against the JAX package's, on the CPU.

The port's meshes are the CPU device repeated; the JAX side runs on its
8 virtual CPU devices (tests/conftest.py). Inputs: the MAI-filtered golden
windows of tests/golden/reference_filtered.npz (labels from their file
names), and a linear head drawn from a numpy seed.

Tolerances: counts exact; gathered probabilities within 1e-5 of JAX's and
within 1e-6 of the port's unsharded ones; one whitened-logcov train step, with
dropout 0, within rtol 1e-5 of JAX's sharded step's loss and within rtol
2e-4 / atol 1e-6 of its parameters (tests/test_parallel.py's limits).
"""

from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from neural_speech_decoding_tpu.io.dataset import TrialDataset as JaxTrialDataset
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.parallel import collective as jax_collective
from neural_speech_decoding_tpu.parallel import mesh as jax_mesh_mod
from neural_speech_decoding_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from neural_speech_decoding_tpu.parallel.sharding import replicate as jax_replicate
from neural_speech_decoding_tpu.train import loop as jax_loop
from neural_speech_decoding_tpu_torch.config import THREE_CLASS_PREFIXES
from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset, parse_label
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.parallel import make_mesh
from neural_speech_decoding_tpu_torch.parallel.collective import all_gather_probs, sharded_eval
from neural_speech_decoding_tpu_torch.train import loop
from neural_speech_decoding_tpu_torch.train.loop import (
    Optimizer,
    TrainConfig,
    TrainState,
    _leaves,
    make_sharded_train_step,
    train,
)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"
PROB_TOL = 1e-5
FLAGSHIP_KW = {"whiten": True, "dropout": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden():
    """The three-class golden trials: (filtered windows, labels, files),
    interleaved over the classes so that any prefix holds all three."""
    with np.load(GOLDEN, allow_pickle=False) as z:
        filtered, files = z["filtered"], [str(f) for f in z["files"]]
    labels = [parse_label(f, THREE_CLASS_PREFIXES) for f in files]
    by_class = [[i for i, label in enumerate(labels) if label == c] for c in range(3)]
    order = [i for trio in zip(*by_class) for i in trio]
    return filtered[order], np.asarray([labels[i] for i in order], np.int32), [files[i] for i in order]


def cpu_mesh(n: int, tp: int = 1):
    return make_mesh(["cpu"] * n, tp=tp)


def jax_mesh(n: int, tp: int = 1):
    return jax_mesh_mod.make_mesh(jax.devices()[:n], tp=tp)


def head_params():
    """A linear head on the windows' per-channel mean square: the
    collectives take any apply function, and this one compiles in
    milliseconds in JAX, where a sharded LSTM takes about 12 s on the CPU."""
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((8, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}


def head_apply(p, x):
    return (x * x).mean(dim=1) @ p["w"] + p["b"]


def jax_head_apply(p, x):
    return (x * x).mean(axis=1) @ p["w"] + p["b"]


@pytest.mark.parametrize("n,dp,tp", [(24, 4, 2), (21, 8, 1)])
def test_sharded_eval_matches_jax(golden, n, dp, tp):
    """Even and uneven batches: the counts equal JAX's and the local ones;
    padding rows count nowhere."""
    x, y, _ = golden
    x, y = x[:n], y[:n]
    params = head_params()
    acc, total = sharded_eval(cpu_mesh(dp * tp, tp=tp), head_apply, params, x, y)
    want_acc, want_total = jax_collective.sharded_eval(jax_mesh(dp * tp, tp=tp), jax_head_apply, params, x, y)
    assert total == want_total == n
    assert acc == want_acc
    with torch.no_grad():
        local = head_apply(params_from_jax(params), torch.from_numpy(x)).argmax(1).numpy()
    assert acc == float((local == y).sum()) / n
    assert 0 < acc < 1  # the head gets some windows right and some wrong


def test_all_gather_probs_matches_jax(golden):
    x = golden[0][:24]
    params = head_params()
    mesh, jm = cpu_mesh(8, tp=2), jax_mesh(8, tp=2)
    got = all_gather_probs(mesh, lambda p, w: torch.softmax(head_apply(p, w), -1), params, x)
    want = jax_collective.all_gather_probs(jm, lambda p, w: jax.nn.softmax(jax_head_apply(p, w), -1), params, x)
    assert got.shape == (24, 3)
    assert np.abs(got - want).max() <= PROB_TOL
    with torch.no_grad():
        local = torch.softmax(head_apply(params_from_jax(params), torch.from_numpy(x)), -1).numpy()
    assert np.abs(got - local).max() <= 1e-6  # only the batch a shard's matmul sees differs
    with pytest.raises(ValueError, match="divisible"):
        all_gather_probs(mesh, head_apply, params, x[:7])


def test_sharded_logcov_train_step_matches_jax(golden):
    """One whitened-logcov8 step (dropout 0, Adam 1e-3, label smoothing
    0.1) over a dp8 mesh in both packages, from the same parameters."""
    x, y = golden[0][:16], golden[1][:16]
    jspec = jax_get_model("logcov8", logm="chebyshev_scan", **FLAGSHIP_KW)
    init = jax.tree_util.tree_map(np.asarray, jspec.fit(jspec.init(jax.random.PRNGKey(0)), x))
    opt = optax.adam(1e-3)
    step = jax_loop.make_train_step(jspec, opt, label_smoothing=0.1)
    jm = jax_mesh(8)
    placed = jax_replicate(jm, init)
    sh_step = jax.jit(step, in_shardings=(None, None, jax_batch_sharding(jm), jax_batch_sharding(jm, ndim=1), None))
    want_params, _, want_m = sh_step(
        placed, opt.init(placed), jax.device_put(x, jax_batch_sharding(jm)),
        jax.device_put(y, jax_batch_sharding(jm, ndim=1)), jax.random.PRNGKey(7),
    )

    spec = get_model("logcov8", logm="chebyshev_scan", **FLAGSHIP_KW)
    params = params_from_jax(init)
    for path, t in _leaves(params):
        t.requires_grad_(not loop._is_buffer(path))
    mesh = cpu_mesh(8)
    optimizer = Optimizer(params, TrainConfig(learning_rate=1e-3, grad_clip=0.0))
    got_m = make_sharded_train_step(spec, optimizer, mesh, label_smoothing=0.1)(
        {mesh.primary: params}, torch.from_numpy(x), torch.from_numpy(y).long(),
        {mesh.primary: torch.Generator().manual_seed(7)},
    )
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["accuracy"]), float(want_m["accuracy"]), rtol=0, atol=1e-6)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_params)[0]:
        got = params
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(leaf), rtol=2e-4, atol=1e-6)


def _datasets(golden, n):
    x, y, files = golden
    prefixes = THREE_CLASS_PREFIXES
    return (TrialDataset(x[:n], y[:n], prefixes, tuple(files[:n])),
            JaxTrialDataset(x[:n], y[:n], prefixes, tuple(files[:n])))


def test_train_with_mesh_batches_and_validation_padding(golden, monkeypatch):
    """train(mesh=) at dp 3: the batch is JAX's max(dp, (32 // dp) * dp) = 30
    and the validation set is JAX's padded one (rows repeated, weight 0);
    at dp 2 (the unsharded batch) the history is the unsharded run's."""
    ds, jds = _datasets(golden, 75)
    cfg = TrainConfig(epochs=2, batch_size=32, learning_rate=3e-3, label_smoothing=0.1, val_fraction=0.2)
    seen = {"x": [], "val": []}
    real_step, real_eval = loop.make_sharded_train_step, loop.make_sharded_eval_fn

    def recording_step(*a, **k):
        step = real_step(*a, **k)

        def wrapped(state, x, y, gens):
            seen["x"].append(tuple(x.shape))
            return step(state, x, y, gens)

        return wrapped

    def recording_eval(*a, **k):
        evaluate = real_eval(*a, **k)

        def wrapped(state, x, y, w):
            seen["val"].append((tuple(x.shape), w.numpy().copy()))
            return evaluate(state, x, y, w)

        return wrapped

    monkeypatch.setattr(loop, "make_sharded_train_step", recording_step)
    monkeypatch.setattr(loop, "make_sharded_eval_fn", recording_eval)
    params, hist = train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg, preprocessed=ds.windows,
                         mesh=cpu_mesh(3), verbose=False)
    _, jval = jds.split(cfg.val_fraction, seed=cfg.seed)
    jx_val, jw_val = jax_loop._pad_to_multiple(np.asarray(jval.windows), 3)
    train_n = 75 - len(jval)
    assert seen["x"] == [(30, 625, 8)] * (2 * (train_n // 30))
    assert [v[0] for v in seen["val"]] == [jx_val.shape] * 2
    np.testing.assert_array_equal(seen["val"][0][1], jw_val)
    assert [h["epoch"] for h in hist] == [0, 1] and params["whitener"].shape == (8, 8, 8)

    monkeypatch.undo()
    _, hist2 = train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg, preprocessed=ds.windows,
                     mesh=cpu_mesh(2), verbose=False)
    _, hist1 = train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg, preprocessed=ds.windows,
                     verbose=False, device="cpu")
    for a, b in zip(hist2, hist1):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4)
        assert a["val_accuracy"] == b["val_accuracy"]


def test_train_state():
    params = {"w": torch.zeros(2)}
    state = TrainState(params=params, optimizer=None)
    assert state.step == 0 and state.params is params
