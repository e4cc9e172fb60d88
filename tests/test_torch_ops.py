"""Port parity: Hilbert operator, pair sums, MAI filter and gate math of
neural_speech_decoding_tpu_torch against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
pair-sums reference is the Pallas kernel in interpret mode, as
tests/test_filter_fused.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.ops import gates as jax_gates
from neural_speech_decoding_tpu.ops import kuramoto as jax_ku
from neural_speech_decoding_tpu.ops.hilbert import _hilbert_transform_matrix as jax_hilbert
from neural_speech_decoding_tpu.ops.pallas.kuramoto import kuramoto_pair_sums as jax_pair_sums
from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.ops import gates
from neural_speech_decoding_tpu_torch.ops import kuramoto as ku
from neural_speech_decoding_tpu_torch.ops.hilbert import (
    _hilbert_transform_matrix,
    analytic_signal,
    analytic_signal_matmul,
    hilbert_matrix,
)
from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
    kuramoto_pair_sums,
    kuramoto_pair_sums_plain,
)

T, C = 625, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # eager torch on tiny tensors is far faster single-threaded, and the
    # suite runs several workers side by side
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_windows(n: int, seed: int, t: int = T) -> np.ndarray:
    """EEG-like raw windows [n, t, 8] float32: per-channel alpha/beta
    sinusoids with random phase and amplitude plus white noise."""
    rng = np.random.default_rng(seed)
    time_s = np.arange(t) / 125.0
    freq = rng.uniform(6.0, 20.0, (n, 1, C))
    phase = rng.uniform(0.0, 2 * np.pi, (n, 1, C))
    amp = rng.uniform(10.0, 60.0, (n, 1, C))
    x = amp * np.sin(2 * np.pi * freq * time_s[None, :, None] + phase)
    x += 8.0 * rng.standard_normal((n, t, C))
    return x.astype(np.float32)


# ------------------------------------------------------------------ (a) Hilbert
@pytest.mark.parametrize("n", [625, 624, 7])
def test_hilbert_matrix_equals_jax(n):
    np.testing.assert_array_equal(_hilbert_transform_matrix(n), jax_hilbert(n))
    h32 = hilbert_matrix(n, CPU).numpy()
    assert h32.dtype == np.float32
    np.testing.assert_array_equal(h32, jax_hilbert(n).astype(np.float32))


def test_analytic_signal_forms_agree():
    x = torch.from_numpy(raw_windows(2, 0).astype(np.float64))
    z = analytic_signal(x, dim=-2)
    re, im = analytic_signal_matmul(x)
    torch.testing.assert_close(z.real, x, rtol=0, atol=1e-9)
    # f64 FFT vs the f64 dense operator: the same linear map
    torch.testing.assert_close(z.imag, im, rtol=0, atol=1e-9)


# --------------------------------------------------------------- (b) pair sums
@pytest.mark.parametrize("batch", [1, 5])
def test_pair_sums_plain_matches_interpret_kernel(batch):
    """Plain twin vs the Pallas kernel in interpret mode: values up to T=625,
    f32 sums of 625 O(1) terms in different orders -> abs 1e-3. The batch
    of 5 is ragged against the kernel's 128 lanes; window 0 has an all-zero
    channel (c2 = 1, s2 = 0)."""
    x = raw_windows(batch, 1)
    x[0, :, 3] = 0.0
    want = np.asarray(jax_pair_sums(jnp.asarray(x), interpret=True))
    got = kuramoto_pair_sums(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, C, C)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0, 3, 3], float(T), rtol=1e-6)
    np.testing.assert_allclose(got, np.swapaxes(got, 1, 2), rtol=0, atol=1e-3)


@pytest.mark.parametrize("batch", [1, 4])
def test_pair_sums_plain_float64_is_exact_reference(batch):
    """In float64 the plain twin is the accuracy reference for the card:
    against the same sums done in numpy float64 with the JAX package's
    operator it agrees to 1e-9, and the float32 twin stays within the
    1e-3 of the pair-sums tests."""
    x = raw_windows(batch, 8)
    x[0, :, 6] = 0.0
    got = kuramoto_pair_sums_plain(torch.from_numpy(x.astype(np.float64))).numpy()
    xd = x.astype(np.float64)
    im = np.einsum("tk,bkc->btc", jax_hilbert(T), xd)
    p2 = xd * xd + im * im
    dead = p2 < np.finfo(np.float64).tiny
    safe = np.where(dead, 1.0, p2)
    c2 = np.where(dead, 1.0, (xd * xd - im * im) / safe)
    s2 = np.where(dead, 0.0, 2.0 * xd * im / safe)
    want = np.einsum("bti,btj->bij", c2, c2) + np.einsum("bti,btj->bij", s2, s2)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    got32 = kuramoto_pair_sums_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got32, want, rtol=0, atol=1e-3)


def test_pair_sums_all_zero_window():
    x = np.zeros((2, T, C), np.float32)
    got = kuramoto_pair_sums(torch.from_numpy(x)).numpy()
    # every sample degenerate: c2 = 1, s2 = 0 -> G = T everywhere
    np.testing.assert_array_equal(got, np.full((2, C, C), float(T), np.float32))


@pytest.mark.parametrize(
    "bad, err",
    [
        (torch.zeros(2, T, C, dtype=torch.float64), TypeError),
        (torch.zeros(2, T, 4), ValueError),
        (torch.zeros(T, C), ValueError),
        (torch.zeros(2, C, T).transpose(1, 2), ValueError),
        (np.zeros((2, T, C), np.float32), TypeError),
    ],
)
def test_pair_sums_wrapper_rejects(bad, err):
    with pytest.raises(err):
        kuramoto_pair_sums(bad)


def test_pair_sums_plain_takes_any_channel_count():
    x = raw_windows(2, 2)[:, :, :3].copy()
    got = kuramoto_pair_sums_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pair_sums(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# -------------------------------------------------------------- (c) MAI filter
def _jax_filter(x, cfg):
    return np.asarray(jax_ku.mai_filter_batch(jnp.asarray(x), cfg))


@pytest.mark.parametrize("entry", ["mai_filter_batch", "mai_filter"])
def test_mai_filter_batch_fast_matches_jax(entry):
    """Fast mode (f32): the JAX package's own fused-vs-stages tolerance,
    2e-4 of the output scale (tests/test_filter_fused.py). mai_filter_batch
    takes the pair-sums route; mai_filter the unfused stages."""
    x = raw_windows(6, 3)
    x[2, :, 5] = 0.0
    want = _jax_filter(x, JaxFilterConfig(precision="fast"))
    if entry == "mai_filter_batch":
        got = ku.mai_filter_batch(x, FilterConfig(precision="fast"), device="cpu")
    else:
        got = ku.mai_filter(torch.from_numpy(x), FilterConfig(precision="fast"))
    assert got.dtype == torch.float32 and got.shape == x.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * scale)


def test_mai_filter_batch_highest_matches_jax_f64():
    """Highest mode: float64 on both sides (x64 is on in this suite), the
    f32 output differs by at most one f32 rounding: 1e-6 of the scale."""
    x = raw_windows(4, 4).astype(np.float64)
    x[1, :, 0] = 0.0
    want = _jax_filter(x, JaxFilterConfig(precision="highest"))
    got = ku.mai_filter_batch(x, FilterConfig(precision="highest"), device="cpu")
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


def test_mai_filter_single_window_matches_jax():
    x = raw_windows(1, 5)[0]
    cfg = JaxFilterConfig(precision="fast")
    want = np.asarray(jax_ku.mai_filter(jnp.asarray(x), cfg))
    got = ku.mai_filter(torch.from_numpy(x), FilterConfig(precision="fast"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("renorm", ["diag", "none"])
def test_effective_lambda_matches_jax(renorm):
    assert ku._effective_lambda(FilterConfig(renorm=renorm)) == jax_ku._effective_lambda(
        JaxFilterConfig(renorm=renorm)
    )


def test_mm_tiny_and_gauss_jordan_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    got = ku._mm_tiny(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_ku._mm_tiny(jnp.asarray(a), jnp.asarray(b)))
    # compensated: both within an ulp of the exact product
    exact = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got, exact, rtol=2e-7, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-6)
    spd = (np.eye(8) + 0.1 * a.T @ a).astype(np.float32)
    got_inv = ku._solve_gauss_jordan(torch.from_numpy(spd), torch.eye(8)).numpy()
    want_inv = np.asarray(jax_ku._solve_gauss_jordan(jnp.asarray(spd), jnp.eye(8, dtype=jnp.float32)))
    np.testing.assert_allclose(got_inv, want_inv, rtol=0, atol=1e-5)


def test_mai_filter_batch_needs_cuda_without_device(monkeypatch):
    """(h) No CUDA and no explicit device: the entry point raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ku.mai_filter_batch(raw_windows(1, 0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ku.mai_filter_batch(raw_windows(1, 0), device="cuda")


# ------------------------------------------------------------------ gate math
def test_rational_gates_match_jax():
    x = np.linspace(-12.0, 12.0, 4001, dtype=np.float32)
    for name in ("tanh", "sigmoid"):
        got = getattr(gates, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jax_gates, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    np.testing.assert_allclose(gates.tanh(torch.from_numpy(x)).numpy(), np.tanh(x), atol=1e-6)


@pytest.mark.parametrize("h", [4, 48])
def test_lstm_gate_block_matches_jax(h):
    rng = np.random.default_rng(7)
    g = rng.standard_normal((3, 4 * h)).astype(np.float32) * 3
    mask = gates.sigmoid_fold_mask(h).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jax_gates.sigmoid_fold_mask(h)))
    pre = g * mask
    got = gates.lstm_gate_block(torch.from_numpy(pre), h)
    want = jax_gates.lstm_gate_block(jnp.asarray(pre), h, "rational")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        gates.tanh(torch.from_numpy(g)).numpy(),
        np.asarray(jax_gates.cell_tanh(jnp.asarray(g), "rational")),
        rtol=0,
        atol=1e-6,
    )
