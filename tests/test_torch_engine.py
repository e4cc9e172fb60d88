"""Port parity: the whole InferenceEngine of neural_speech_decoding_tpu_torch
(raw windows -> MAI filter -> LSTM -> softmax) against the JAX package's
engine on synthetic raw windows, plus the .pth loader round trip and the
engine's serving contract, on the CPU.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.lstm import decoder_apply
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch as jax_filter_batch
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu_torch.io.checkpoint import load_decoder_params
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine, _bucket

REPO = Path(__file__).resolve().parents[1]
NPZ3 = REPO / "checkpoints" / "lstm3_retrained.npz"
NPZ5 = REPO / "checkpoints" / "lstm5.npz"
T, C = 625, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8]: sinusoids + slow modulation + noise
    at unit scale, as runtime/board.SyntheticBoard streams them."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(str(NPZ3), device="cpu")


def test_bucket_rounding():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 1000)] == [1, 2, 4, 8, 8, 1024]


def test_engine_matches_jax_engine(engine):
    """(e) Whole pipeline on 12 raw windows (bucketed to 16; window 3 has a
    dead channel): <= 1e-4 max |delta logit| against the JAX fast path,
    and the JAX engine's probabilities to 5e-5 (a logit delta of 1e-4
    moves a softmax probability by at most 5e-5)."""
    x = raw_windows(12, 0)
    x[3, :, 6] = 0.0
    params = jax_load_npz(NPZ3)
    want_logits = np.asarray(
        decoder_apply(params, jax_filter_batch(jnp.asarray(x), JaxFilterConfig(precision="fast")), JaxDecoderConfig())
    )
    got_logits = engine.logits_batch(x)
    assert got_logits.shape == (12, 3)
    assert np.abs(got_logits - want_logits).max() <= 1e-4

    want_probs = JaxEngine(str(NPZ3)).predict_batch(x)
    got_probs = engine.predict_batch(x)
    assert got_probs.dtype == np.float32
    np.testing.assert_allclose(got_probs, want_probs, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got_probs.argmax(1), want_probs.argmax(1))


def test_padded_batch_matches_exact(engine):
    x = raw_windows(8, 1)
    padded = engine.predict_batch(x[:5])  # bucket 8, three zero windows
    exact = engine.predict_batch(x)[:5]
    np.testing.assert_allclose(padded, exact, rtol=0, atol=1e-6)


def test_predict_contract_and_stats(engine):
    before = engine.stats["windows"]
    probs, label = engine.predict(raw_windows(1, 2)[0])
    assert probs.shape == (3,) and probs.dtype == np.float32
    assert abs(float(probs.sum()) - 1.0) < 1e-5
    assert label == engine.class_names[int(probs.argmax())]
    assert engine.predict_batch(np.zeros((0, T, C), np.float32)).shape == (0, 3)
    assert engine.stats == {"windows": before + 1, "guard_flagged": 0}


def test_engine_turns_tf32_off(engine):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_five_class_engine():
    eng = InferenceEngine(str(NPZ5), model="lstm5", device="cpu")
    assert eng.class_names[3:] == ("Yes", "No")
    assert eng.predict_batch(raw_windows(2, 3)).shape == (2, 5)


def test_sample_rate_quirk():
    eng = InferenceEngine(str(NPZ3), sample_rate=250, device="cpu")
    assert eng.config.sample_rate == 250
    assert eng.config.window_samples == 1250


def test_engine_refusals(monkeypatch):
    with pytest.raises(ValueError, match="model_path or params"):
        InferenceEngine(device="cpu")
    with pytest.raises(ValueError, match="LSTM-family"):
        InferenceEngine(str(REPO / "model.pth"), model="eegnet", device="cpu")
    # (h) no CUDA and no explicit device: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(str(NPZ3))


def test_engine_takes_the_jax_keywords():
    """turbo, donate and mesh, as the JAX InferenceEngine takes them: the
    defaults serve as before, any other value raises NotImplementedError
    naming ROADMAP.md (never TypeError)."""
    engine = InferenceEngine(str(NPZ3), turbo=False, donate=False, mesh=None, device="cpu")
    assert engine.predict_batch(raw_windows(2, 4)).shape == (2, 3)
    for kw in ({"turbo": True}, {"donate": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            InferenceEngine(str(NPZ3), device="cpu", **kw)


def test_pth_round_trip(tmp_path):
    """(f) The JAX package writes a reference-layout .pth from the shipped
    .npz; the port's torch.load-based loader reads back the same
    parameters, and an engine built from it decodes as the .npz engine."""
    params = jax_load_npz(NPZ3)
    path = tmp_path / "lstm3.pth"
    save_torch_checkpoint(path, decoder_params_to_torch_state(params))
    loaded = load_decoder_params(path)
    assert len(loaded["lstm"]) == len(params["lstm"])
    for got, want in zip(loaded["lstm"], params["lstm"]):
        for k in ("w_ih", "w_hh", "b"):
            np.testing.assert_array_equal(got[k], want[k])
    for group, keys in (("attn", ("w", "b")), ("ln", ("scale", "bias")), ("fc1", ("w", "b")), ("fc2", ("w", "b"))):
        for k in keys:
            assert loaded[group][k].shape == np.asarray(params[group][k]).shape
            np.testing.assert_array_equal(loaded[group][k], params[group][k])

    x = raw_windows(2, 4)
    from_pth = InferenceEngine(str(path), device="cpu").predict_batch(x)
    from_npz = InferenceEngine(str(NPZ3), device="cpu").predict_batch(x)
    np.testing.assert_array_equal(from_pth, from_npz)
