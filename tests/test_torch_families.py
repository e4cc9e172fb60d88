"""Port parity: the EEGNet, TCN, transformer and LRU families of
neural_speech_decoding_tpu_torch against the JAX package's, on the CPU.

- Every shipped checkpoint of those families (the 13 of
  tests/test_checkpoints_zoo.py) through the JAX spec's `apply` and the
  port's, on the same golden filtered windows (a serving batch of 64, and
  run_trials' single window): max |delta logit| <= 1e-4 (the JAX package's
  f32 budget) with equal argmax.
- lru / lru5 in both engines and tcn_small / tcn_wide, from parameters the
  JAX package's own init draws, to the same limit.
- The whole InferenceEngine (raw windows -> fast filter -> decoder ->
  softmax) against the JAX engine: |delta prob| <= 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models import registry as jreg
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models import lru as tlru
from neural_speech_decoding_tpu_torch.models import registry as treg
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"
T, C = 625, 8
LOGIT_TOL = 1e-4
PROB_TOL = 1e-5

# the shipped checkpoints of the families this slice ports
SHIPPED = [
    ("eegnet", "eegnet3"),
    ("eegnet", "eegnet3_aug"),
    ("eegnet", "eegnet3_best"),
    ("eegnet", "eegnet3_cosine"),
    ("eegnet5", "eegnet5_best"),
    ("transformer", "transformer3"),
    ("transformer", "transformer3_aug"),
    ("transformer", "transformer3_best"),
    ("transformer5", "transformer5_best"),
    ("tcn", "tcn3_best"),
    ("tcn", "tcn3_cosine"),
    ("tcn", "tcn3_deploy"),
    ("tcn5", "tcn5_best"),
]
# families without a shipped checkpoint: JAX-init parameters
INIT = [
    ("lru", {"scan_impl": "chunked"}),
    ("lru", {"scan_impl": "associative"}),
    ("lru5", {"scan_impl": "chunked"}),
    ("lru5", {"scan_impl": "associative"}),
    ("tcn_small", {}),
    ("tcn_wide", {}),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def filtered():
    with np.load(GOLDEN, allow_pickle=False) as z:
        x = z["filtered"]
    return x[np.linspace(0, len(x) - 1, 64).astype(int)].astype(np.float32)


def raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8], as runtime/board.SyntheticBoard
    streams them."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    return x.astype(np.float32)


def _check_logits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("n", [64, 1])  # a serving batch, and run_trials' single window
@pytest.mark.parametrize("family, checkpoint", SHIPPED)
def test_shipped_checkpoint_logits_match_jax(filtered, family, checkpoint, n):
    params = jax_load_npz(CKPT / f"{checkpoint}.npz")
    x = filtered[:n]
    want = np.asarray(jreg.get_model(family).apply(params, jnp.asarray(x)))
    got = treg.get_model(family).apply(params_from_jax(load_params_npz(CKPT / f"{checkpoint}.npz")), torch.from_numpy(x))
    _check_logits(got.numpy(), want)


@pytest.mark.parametrize("family, kw", INIT, ids=[f"{f}-{kw.get('scan_impl', 'init')}" for f, kw in INIT])
def test_init_params_logits_match_jax(filtered, family, kw):
    jspec = jreg.get_model(family, **kw)
    params = jspec.init(jax.random.PRNGKey(3))
    want = np.asarray(jspec.apply(params, jnp.asarray(filtered)))
    got = treg.get_model(family, **kw).apply(params_from_jax(params), torch.from_numpy(filtered))
    _check_logits(got.numpy(), want)


@pytest.fixture(scope="module")
def lru_params():
    return jreg.get_model("lru").init(jax.random.PRNGKey(7))


def test_lru_chunked_matches_associative(filtered, lru_params):
    """The port's chunked engine against its own doubling scan: states and
    logits within 1e-4, at the default chunk (125) and at chunk 25."""
    p = params_from_jax(lru_params)
    x = torch.from_numpy(filtered[:16])
    assoc = tlru._lru_states_associative(p, x)
    scale = float(assoc.abs().max())
    for chunk in (None, 25):
        states = tlru._lru_states_chunked(p, x, chunk)
        assert states.dtype == torch.complex64 and states.shape == (16, T, 64)
        assert float((states - assoc).abs().max()) <= 1e-4 * max(scale, 1.0)
        got = tlru.lru_apply(p, x, tlru.LRUConfig(chunk=chunk))
        want = tlru.lru_apply(p, x, tlru.LRUConfig(scan_impl="associative"))
        assert float((got - want).abs().max()) <= LOGIT_TOL
    assert tlru._chunk_len(625, None) == 125 and tlru._chunk_len(97, None) == 97
    with pytest.raises(ValueError, match="does not divide"):
        tlru.lru_apply(p, x, tlru.LRUConfig(chunk=7))
    with pytest.raises(ValueError, match="unknown scan_impl"):
        tlru.lru_apply(p, x, tlru.LRUConfig(scan_impl="serial"))


@pytest.mark.parametrize("scan_impl", ["chunked", "associative"])
def test_lru_nan_window_stays_nan(filtered, lru_params, scan_impl):
    """A window holding a NaN gives NaN logits in both packages (the
    chunked carry starts from u * 0), and leaves the other windows as
    they were."""
    x = filtered[:4].copy()
    x[1, 300, 2] = np.nan
    cfg_kw = {"scan_impl": scan_impl}
    want = np.asarray(jreg.get_model("lru", **cfg_kw).apply(lru_params, jnp.asarray(x)))
    got = treg.get_model("lru", **cfg_kw).apply(params_from_jax(lru_params), torch.from_numpy(x)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    keep = [0, 2, 3]
    _check_logits(got[keep], want[keep])


def test_checkpoint_blocks_load_as_lists():
    """`blocks.N.*` keys come back as lists, as the JAX loader returns them."""
    for name in ("tcn3_deploy", "transformer3_best"):
        ours, theirs = load_params_npz(CKPT / f"{name}.npz"), jax_load_npz(CKPT / f"{name}.npz")
        assert isinstance(ours["blocks"], list) and isinstance(theirs["blocks"], list)
        assert len(ours["blocks"]) == len(theirs["blocks"])
        np.testing.assert_array_equal(ours["blocks"][1]["w1"], theirs["blocks"][1]["w1"])
        assert isinstance(params_from_jax(ours)["blocks"], list)
    assert load_params_npz(CKPT / "transformer3_best.npz")["pos"].shape == (25, 64)


ENGINE_CASES = [
    ("eegnet", "eegnet3_best"),
    ("tcn", "tcn3_deploy"),
    ("transformer", "transformer3_best"),
    ("eegnet5", "eegnet5_best"),
    ("lru", None),
]


@pytest.mark.parametrize("family, checkpoint", ENGINE_CASES)
def test_engine_matches_jax(family, checkpoint):
    """InferenceEngine(model=family, device="cpu") on 6 raw windows (bucket
    8) against the JAX engine: |delta prob| <= 1e-5, equal argmax and
    stats, the same class names."""
    x = raw_windows(6, 11)
    if checkpoint is None:
        params = jreg.get_model(family).init(jax.random.PRNGKey(5))
        jax_engine, eng = JaxEngine(params=params, model=family), InferenceEngine(params=params, model=family, device="cpu")
    else:
        path = str(CKPT / f"{checkpoint}.npz")
        jax_engine, eng = JaxEngine(path, model=family), InferenceEngine(path, model=family, device="cpu")
    want = jax_engine.predict_batch(x)
    got = eng.predict_batch(x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert eng.stats == jax_engine.stats == {"windows": 6, "guard_flagged": 0}
    assert eng.class_names == jax_engine.class_names
    probs, label = eng.predict(x[0])
    assert probs.shape == (len(eng.class_names),) and label in eng.class_names


def test_pth_is_lstm_only():
    """A .pth checkpoint for a non-LSTM family: JAX's ValueError."""
    for family in ("eegnet", "tcn", "transformer", "lru"):
        with pytest.raises(ValueError, match="LSTM-family"):
            InferenceEngine(str(CKPT / "x.pth"), model=family, device="cpu")
        with pytest.raises(ValueError, match="LSTM-family"):
            JaxEngine(str(CKPT / "x.pth"), model=family)


def test_random_lru_params_mirror_jax_init():
    """No LRU checkpoint is shipped, so the card checks draw parameters with
    numpy: the same tree, shapes and dtypes as the JAX init, |lambda| on
    the ring [r_min, r_max], and logits the JAX apply agrees with."""
    cfg = tlru.LRUConfig()
    ours = tlru.random_lru_params(0, cfg)
    theirs = jreg.get_model("lru").init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
    mod = np.exp(-np.exp(ours["nu"].astype(np.float64)))
    assert cfg.r_min - 1e-6 <= mod.min() and mod.max() <= cfg.r_max + 1e-6
    x = raw_windows(4, 0)
    want = np.asarray(jreg.get_model("lru").apply(ours, jnp.asarray(x)))
    got = treg.get_model("lru").apply(params_from_jax(ours), torch.from_numpy(x)).numpy()
    _check_logits(got, want)
