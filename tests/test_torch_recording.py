"""Port parity: epoching (ops/epoching.py), InferenceEngine.decode_recording
and predict_batch_async of neural_speech_decoding_tpu_torch against the JAX
package, on the CPU.

- frame_signal / num_frames / frame_times: bit-equal to JAX.
- decode_recording at hop 1.0 s and 0.5 s with max_batch below the window
  count (several chunks): probabilities within 1e-5, start times equal.
- predict_batch_async: the same probabilities as predict_batch, guard
  flags parked on the device until `stats` is read, and the same stats.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.ops import epoching as jep
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu_torch.ops import epoching as tep
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
T, C = 625, 8
PROB_TOL = 1e-5
WHITENED = dict(model="logcov8", model_kw={"whiten": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def recording(total: int, seed: int) -> np.ndarray:
    """A board-like continuous recording [total, 8] at 125 Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(total) / 125.0
    ch = np.arange(C)
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + ch)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None])
    x = x + 0.35 * rng.standard_normal((total, C))
    return x.astype(np.float32)


@pytest.mark.parametrize("total, window, hop", [(2000, 625, 125), (2000, 625, 62), (625, 625, 125),
                                                (1000, 97, 1), (624, 625, 125)])
def test_epoching_equals_jax(total, window, hop):
    assert tep.num_frames(total, window, hop) == jep.num_frames(total, window, hop)
    starts, ends = tep.frame_times(total, window, hop, 125)
    jstarts, jends = jep.frame_times(total, window, hop, 125)
    assert starts.dtype == torch.float64
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(jends))
    sig = recording(total, 0)
    if tep.num_frames(total, window, hop) == 0:
        with pytest.raises(ValueError, match="shorter than window"):
            tep.frame_signal(torch.from_numpy(sig), window, hop)
        with pytest.raises(ValueError, match="shorter than window"):
            jep.frame_signal(jnp.asarray(sig), window, hop)
        return
    got = tep.frame_signal(torch.from_numpy(sig), window, hop)
    want = np.asarray(jep.frame_signal(jnp.asarray(sig), window, hop))
    assert got.shape == want.shape == (tep.num_frames(total, window, hop), window, C)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("checkpoint, kw, hop", [
    ("tcn3_deploy", {"model": "tcn"}, 1.0),
    ("tcn3_deploy", {"model": "tcn"}, 0.5),
    ("logcov8w_deploy_s0", WHITENED, 1.0),
])
def test_decode_recording_matches_jax(checkpoint, kw, hop):
    """A 16 s recording: 12 windows at hop 1 s, 23 at hop 0.5 s, decoded in
    chunks of 5 (so several, the last one short)."""
    path = str(CKPT / f"{checkpoint}.npz")
    sig = recording(2000, 1)
    jax_engine = JaxEngine(path, **kw)
    want, want_starts = jax_engine.decode_recording(sig, hop_seconds=hop, max_batch=5)
    eng = InferenceEngine(path, device="cpu", **kw)
    got, starts = eng.decode_recording(sig, hop_seconds=hop, max_batch=5)
    n = 12 if hop == 1.0 else 23
    assert got.shape == want.shape == (n, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(starts, np.asarray(want_starts))
    assert eng.stats == jax_engine.stats
    assert eng.stats["windows"] == n


def test_short_recording_raises():
    path = str(CKPT / "tcn3_deploy.npz")
    sig = recording(600, 2)
    for eng in (InferenceEngine(path, model="tcn", device="cpu"), JaxEngine(path, model="tcn")):
        with pytest.raises(ValueError, match="shorter than one 625-sample window"):
            eng.decode_recording(sig)


@pytest.mark.parametrize("checkpoint, kw", [("tcn3_deploy", {"model": "tcn"}), ("logcov8w_deploy_s0", WHITENED)])
def test_predict_batch_async_equals_predict_batch(checkpoint, kw):
    """predict_batch_async returns a tensor on the engine's device with the
    probabilities predict_batch returns; it counts the windows at once
    (families without a guard) or parks the guard flags until `stats` is
    read (logcov), and both engines' stats agree after both calls, as
    JAX's do."""
    path = str(CKPT / f"{checkpoint}.npz")
    x = recording(6 * T, 3).reshape(6, T, C)
    x[4] = 0.0
    eng = InferenceEngine(path, device="cpu", **kw)
    jax_engine = JaxEngine(path, **kw)
    sync = eng.predict_batch(x)
    out = eng.predict_batch_async(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.device == eng.device and out.shape == (6, 3)
    np.testing.assert_allclose(out.numpy(), sync, rtol=0, atol=1e-6)
    assert len(eng._parked) == (1 if kw["model"] == "logcov8" else 0)
    np.testing.assert_allclose(
        np.asarray(jax_engine.predict_batch_async(jnp.asarray(x))), out.numpy(), rtol=0, atol=PROB_TOL
    )
    jax_engine.predict_batch(x)
    assert eng.stats == jax_engine.stats
    assert eng.stats["windows"] == 12 and not eng._parked


def test_parked_flags_are_bounded(monkeypatch):
    """Past _MAX_PARKED_FLAGS parked vectors the list is folded, so a caller
    that never reads `stats` cannot pin unbounded device memory."""
    eng = InferenceEngine(str(CKPT / "logcov8w_deploy_s0.npz"), device="cpu", **WHITENED)
    monkeypatch.setattr(eng, "_MAX_PARKED_FLAGS", 2)
    x = torch.from_numpy(recording(2 * T, 4).reshape(2, T, C))
    for _ in range(3):
        eng.predict_batch_async(x)
    assert not eng._parked
    assert eng._stats["windows"] == 6
    eng.predict_batch_async(x)
    assert len(eng._parked) == 1
    assert eng.stats == {"windows": 8, "guard_flagged": 0}
