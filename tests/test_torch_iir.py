"""Port parity: the fused zero-phase IIR preprocessing of
neural_speech_decoding_tpu_torch (ops/iir.py, ops/kernels/iir.py: the
cascade kernel's plain twin on the CPU) against the JAX package's Pallas
kernel in interpret mode and against scipy in float64.
"""


import numpy as np
import pytest
import scipy.signal
import torch

from neural_speech_decoding_tpu.ops.iir import butter_sos as jax_butter_sos
from neural_speech_decoding_tpu.ops.pallas.iir import collector_stages as jax_collector_stages
from neural_speech_decoding_tpu.ops.pallas.iir import fused_preprocess as jax_fused_preprocess
from neural_speech_decoding_tpu_torch.ops.iir import butter_sos
from neural_speech_decoding_tpu_torch.ops.kernels.iir import (
    collector_stages,
    fused_preprocess,
    iir_cascade,
    iir_cascade_plain,
    stack_sos,
)

TWIN_TOL = 1e-5  # of scale: float32 sections in different rounding orders
SCIPY_TOL = 1e-4  # of scale: the JAX package's own limit (tests/test_pallas_iir.py:36)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 625, 8)) * 5 + 2).astype(np.float32)


@pytest.fixture(scope="module")
def jax_reference(batch):
    """The JAX Pallas kernel in interpret mode, once per setting."""
    stages = jax_collector_stages()
    plain = jax_fused_preprocess(batch, stages, block_n=1, block_t=125, interpret=True)
    zscored = jax_fused_preprocess(
        batch, stages, detrend=False, zscore=True, block_n=1, block_t=125, interpret=True
    )
    return np.asarray(plain), np.asarray(zscored)


def scipy_combined_filtfilt(x_btc: np.ndarray, stages) -> np.ndarray:
    """The fused kernel's semantics in float64: detrend, every section
    forward, then every section backward, no padding."""
    sos = stack_sos(stages)
    x = x_btc - x_btc.mean(axis=1, keepdims=True)
    fwd = scipy.signal.sosfilt(sos, x, axis=1)
    return scipy.signal.sosfilt(sos, fwd[:, ::-1, :], axis=1)[:, ::-1, :]


@pytest.mark.parametrize("args", [
    ("bandstop", 4, 39.5, 40.5, 125.0),
    ("bandpass", 2, 3.0, 48.0, 125.0),
    ("lowpass", 3, 0.0, 30.0, 250.0),
    ("highpass", 2, 1.0, 0.0, 125.0),
])
def test_butter_sos_equals_jax(args):
    assert butter_sos(*args) == jax_butter_sos(*args)


def test_butter_sos_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown filter kind"):
        butter_sos("notch", 2, 1.0, 2.0, 125.0)


def test_collector_stages_equal_jax():
    stages = collector_stages()
    assert [len(s) for s in stages] == [4, 2, 4, 4]
    assert stack_sos(stages).shape == (14, 6)
    np.testing.assert_array_equal(stack_sos(stages), stack_sos(jax_collector_stages()))


def test_fused_preprocess_matches_pallas_interpret(batch, jax_reference):
    """Detrend and the 14-section cascade, forward then reversed: the twin
    against the JAX kernel in interpret mode, within 1e-5 of scale."""
    want, _ = jax_reference
    got = fused_preprocess(batch, collector_stages(), device="cpu")
    assert got.shape == batch.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= TWIN_TOL


def test_fused_preprocess_matches_scipy_composite(batch):
    stages = collector_stages()
    got = fused_preprocess(batch, stages, device="cpu").numpy()
    ref = scipy_combined_filtfilt(batch.astype(np.float64), stages)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= SCIPY_TOL


def test_fused_preprocess_zscore_without_detrend(batch, jax_reference):
    """zscore=True with detrend=False against JAX (same 1e-5 of scale), and
    each series has mean 0 and standard deviation 1."""
    _, want = jax_reference
    got = fused_preprocess(batch, collector_stages(), detrend=False, zscore=True, device="cpu").numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= TWIN_TOL
    np.testing.assert_allclose(got.mean(axis=1), 0.0, atol=1e-5)
    np.testing.assert_allclose(got.std(axis=1), 1.0, atol=1e-2)


def test_fused_preprocess_suppresses_line_noise():
    fs = 125.0
    t = np.arange(625) / fs
    x = np.stack([np.sin(2 * np.pi * 10 * t) + 3.0 * np.sin(2 * np.pi * 60 * t)] * 8, axis=1)
    y = fused_preprocess(x[None].astype(np.float32), collector_stages(), device="cpu")[0, :, 0].numpy()
    spec = np.abs(np.fft.rfft(y))
    f = np.fft.rfftfreq(625, 1 / fs)
    assert spec[np.argmin(np.abs(f - 60))] < 0.01 * spec[np.argmin(np.abs(f - 10))]


def test_fused_preprocess_float64_twin_is_scipy(batch):
    """The twin in float64 is the scipy composite (the accuracy reference
    the card's kernel is read against)."""
    sos = stack_sos(collector_stages())
    x = torch.from_numpy(batch.astype(np.float64))
    x = x - x.mean(dim=1, keepdim=True)
    got = iir_cascade_plain(x, sos).numpy()
    ref = scipy_combined_filtfilt(batch.astype(np.float64), collector_stages())
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def test_fused_preprocess_device_and_input_checks(monkeypatch, batch):
    with pytest.raises(TypeError):
        iir_cascade(torch.from_numpy(batch).double(), stack_sos(collector_stages()))
    with pytest.raises(ValueError):
        iir_cascade(torch.from_numpy(batch)[0], stack_sos(collector_stages()))
    with pytest.raises(ValueError, match="sos"):
        iir_cascade(torch.from_numpy(batch), np.zeros((3, 5)))
    # no CUDA and no explicit device: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_preprocess(batch, collector_stages())
