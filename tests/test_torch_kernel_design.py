"""The algorithms of the port's redesigned CUDA kernels, walked in numpy on
the CPU, where no card runs them.

- Pair sums (csrc/kuramoto_pair_sums.cu): the Hilbert step as the near
  taps in the time domain plus an in-place mixed-radix FFT round trip from
  the wrapper's stage plan and tables (ops/kernels/kuramoto.fft_plan,
  fft_tables, round_trip_gain): decimation-in-frequency stages, the
  permuted multiplier, the adjoint stages, with the kernel's radix-2..5
  butterflies and its direct-DFT stage. In float64 it is the dense
  operator of the JAX package; in float32, with the kernel's direct sum
  near z = 0, its pair sums stay within the card limit of the twin and
  within twice the twin's distance from float64.
- Rational features (csrc/logcov_feats.cu, logcov_feats_kernel): Householder
  tridiagonalisation, one O(C^2) shifted tridiagonal inverse a pole,
  back-transformation. In float64 it is spd.logm_rational; in float32 it
  stays within the card limit of the twin.
- Chebyshev series (csrc/sym8_eigen.cuh, shared by the feature kernel's
  Chebyshev mode and the Clenshaw kernel): Householder and implicit-shift
  QL in float64, the scalar series at the eigenvalues, Z diag(p) Z^T and
  the back-transformation. In float64 it is spd.logm_chebyshev; in the
  kernels' precisions it stays within the card limit of the twin and
  within twice the twin's error against float64, edge cases included.
- IIR cascade (csrc/iir_cascade.cu): the lane pipeline (G lanes a series,
  K sections a lane, each section one step behind the one before it,
  identity slots past the last section, lane 0 reading a chunk ahead, the
  last lane writing in place, the reverse pass walking the same buffer
  from its end) in float32 with separate products and sums, bit-equal to
  the CPU twin; the launch plan's rule at the main path's batches and at
  the edge of a block's shared memory on an H100, and the staged shapes'
  shared-memory reads free of bank conflicts.
- Band grams (csrc/bandcov_grams.cu): a warp a (window, band), 4-row
  chunks through the m8n8k4 float64 fragments (one loaded value a lane,
  both its A and its B element; zero lanes past a band's end; the
  accumulator-to-pair map), for the logcov5, logcov8 and logcov12 layouts
  and random 16-band ones: exact in float64 on integer rows, within one
  float32 rounding of the exact grams on Gaussian rows. The lean wrapper
  on the CPU: autograd only for a gradient, layouts validated once and
  cached, bad layouts and tensors refused on every call.
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.ops.hilbert import _hilbert_transform_matrix as jax_hilbert
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models import logcov
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops import spd
from neural_speech_decoding_tpu_torch.ops.kernels import bandcov, iir
from neural_speech_decoding_tpu_torch.ops.kernels import kuramoto as ku

REPO = Path(__file__).resolve().parents[1]
C = 8
LENGTHS = [1, 2, 97, 256, 625, 1250]
# T = 77 = 7 x 11: two direct-DFT stages, the last of them unfused;
# 210 = 7 x 2 x 3 x 5: every stage kind at once
MORE_LENGTHS = [77, 210]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ pair sums (FFT)
SOURCE = (Path(__file__).resolve().parents[1] / "neural_speech_decoding_tpu_torch" / "csrc"
          / "kuramoto_pair_sums.cu").read_text()
REFINE_BELOW = float(re.search(r"kRefineBelow = ([0-9.e+-]+)f;", SOURCE).group(1))


def _dft_small(v, r, sign, tw, t, const=None):
    """The kernel's R-point butterflies (Dft<R, Sg>): X_k = sum_n v_n
    exp(sign 2 pi i n k / R); radix 2..5 by its formulas with its constants
    rounded to `const` (default: the arithmetic's precision), any other
    radix by the direct sum over the twiddle table (generic_stage)."""
    f = const or v[0].real.dtype.type
    i_s = 1j * sign
    if r == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if r == 3:
        t_ = v[1] + v[2]
        d = (v[1] - v[2]) * f(0.86602540378443864676)
        b = v[0] - t_ * f(0.5)
        return [v[0] + t_, b + i_s * d, b - i_s * d]
    if r == 4:
        t0, t1, t2, t3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        return [t0 + t2, t1 + i_s * t3, t0 - t2, t1 - i_s * t3]
    if r == 5:
        c1, c2 = f(0.30901699437494742410), f(-0.80901699437494742410)
        s1, s2 = f(0.95105651629515357212), f(0.58778525229247312917)
        t1, t2, t3, t4 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
        b1, b2 = v[0] + (t1 * c1 + t2 * c2), v[0] + (t1 * c2 + t2 * c1)
        d1, d2 = t3 * s1 + t4 * s2, t3 * s2 - t4 * s1
        return [v[0] + (t1 + t2), b1 + i_s * d1, b2 + i_s * d2, b2 - i_s * d2, b1 - i_s * d1]
    w = [tw[((n * k) % r) * (t // r)] for k in range(r) for n in range(r)]
    w = [x if sign < 0 else np.conj(x) for x in w]
    return [sum(v[n] * w[k * r + n] for n in range(r)) for k in range(r)]


def _fft_part(x, dtype=np.complex128, calibrated=False, const=None):
    """The FFT's part of im = H x for x [S, T] along T, as the kernel does
    it: in place, the stages of fft_plan(T) forward (twiddle after the
    butterfly, w_len^(n0 k1)), the gain at the last stage's write (fused
    with the first inverse stage for a fixed radix), the adjoint stages
    last to first. `calibrated`: the gain times round_trip_gain, as in the
    kernel's table; `const`: the precision of the constants (twiddles,
    butterflies) where it differs from the arithmetic's."""
    s, t = x.shape
    plan = ku.fft_plan(t)
    tw64, gain64, _ = ku.fft_tables(t)
    if calibrated:
        gain64 = gain64 * ku.round_trip_gain(t)
    real = np.float32 if dtype == np.complex64 else np.float64
    tw = tw64.astype(np.complex64).astype(dtype) if const is np.float32 else tw64.astype(dtype)
    gain = gain64.astype(real)
    buf = x.astype(dtype).copy()

    def groups(length, r):
        m = length // r
        for b in range(t // r):
            blk, n0 = divmod(b, m)
            yield blk * length + n0, n0, m, t // length

    def hilbert_gain(v, g):  # -i g v
        return (g * v.imag - 1j * (g * v.real)).astype(dtype)

    length = t
    for st, r in enumerate(plan):
        last = st == len(plan) - 1
        for base, n0, m, step in groups(length, r):
            v = _dft_small([buf[:, base + j * m] for j in range(r)], r, -1, tw, t, const)
            if last and r <= 5:  # the middle stage: gain, then the inverse butterfly
                v = [hilbert_gain(v[k], gain[base + k]) for k in range(r)]
                v = _dft_small(v, r, +1, tw, t, const)
            else:
                v = [v[k] * tw[n0 * k * step] for k in range(r)]
                if last:
                    v = [hilbert_gain(v[k], gain[base + k * m]) for k in range(r)]
            for k in range(r):
                buf[:, base + k * m] = v[k]
        length //= r
    if not plan:
        buf = hilbert_gain(buf, gain[0])
    for st in range(len(plan) - 1, -1, -1):
        r = plan[st]
        length *= r
        if st == len(plan) - 1 and r <= 5:
            continue
        for base, n0, m, step in groups(length, r):
            v = [buf[:, base + k * m] * np.conj(tw[n0 * k * step]) for k in range(r)]
            v = _dft_small(v, r, +1, tw, t, const)
            for j in range(r):
                buf[:, base + j * m] = v[j]
    return buf.real


def _hilbert_step(x, dtype=np.complex128, calibrated=False):
    """im = H x as the kernel forms it away from z = 0: the FFT's part,
    then the near taps in the time domain, d = near_taps(T) .. 1, the
    column's entry d times x[t - d], then entry T - d times x[t + d]."""
    t = x.shape[1]
    real = np.float32 if dtype == np.complex64 else np.float64
    im = _fft_part(x, dtype, calibrated).astype(real)
    _, _, col = ku.fft_tables(t)
    x = x.astype(real)
    for d in range(ku.near_taps(t), 0, -1):
        im = im + real(np.float32(col[d])) * np.roll(x, d, axis=1)
        im = im + real(np.float32(col[t - d])) * np.roll(x, -d, axis=1)
    return im


def test_constants_match_the_kernel_source():
    """The tables assume the kernel's number of near taps."""
    assert f"constexpr int kNear = {ku.NEAR_TAPS};" in SOURCE
    assert 0 < REFINE_BELOW < 1e-2


@pytest.mark.parametrize("t", LENGTHS + MORE_LENGTHS)
def test_fft_plan_and_positions(t):
    """The plan multiplies out to T, keeps radices 2..5 last (so the last
    stage fuses), and the digit reversal is a permutation."""
    plan = ku.fft_plan(t)
    assert int(np.prod(plan, dtype=np.int64)) == t and all(r >= 2 for r in plan)
    fixed = [r <= 5 for r in plan]
    assert fixed == sorted(fixed)  # direct-DFT stages first
    assert sorted(ku.fft_positions(t).tolist()) == list(range(t))


@pytest.mark.parametrize("t", LENGTHS + MORE_LENGTHS)
def test_fft_walk_is_the_dense_hilbert_operator(t):
    """float64 walk through the tables and plan plus the near taps = the
    JAX package's dense operator H @ x to 1e-10 relative, 8 series at once."""
    x = np.random.default_rng(t).standard_normal((C, t)) * 40.0
    want = x @ jax_hilbert(t).T
    got = _hilbert_step(x)
    assert np.abs(got - want).max() <= 1e-10 * max(np.abs(want).max(), np.abs(x).max())


@pytest.mark.parametrize("t", LENGTHS + MORE_LENGTHS)
def test_fft_walk_keeps_a_zero_series_exactly_zero(t):
    """Each series is its own transform: an all-zero channel beside a
    railed one comes out exactly 0 (so its c2 stays 1 and G[i, i] = T)."""
    x = np.zeros((C, t))
    x[1] = 1e6 * np.sign(np.random.default_rng(1).standard_normal(t))
    for dtype in (np.complex128, np.complex64):
        got = _hilbert_step(x.astype(np.float32), dtype, calibrated=True)
        assert np.all(got[0] == 0.0) and np.all(got[2:] == 0.0)


@pytest.mark.parametrize("t", [1, 2, 97, 625, 1250])
def test_tables_layout(t):
    """device_tables: float32 [4 T] = twiddles (re, im), the permuted gain
    times round_trip_gain, the operator's first column; H is circulant in
    that column."""
    tw, gain, col = ku.fft_tables(t)
    flat = ku.device_tables(t, torch.device("cpu")).numpy()
    assert flat.dtype == np.float32 and flat.shape == (4 * t,)
    np.testing.assert_array_equal(flat[: 2 * t : 2], tw.real.astype(np.float32))
    np.testing.assert_array_equal(flat[1 : 2 * t : 2], tw.imag.astype(np.float32))
    np.testing.assert_array_equal(flat[2 * t : 3 * t], (gain * ku.round_trip_gain(t)).astype(np.float32))
    np.testing.assert_array_equal(flat[3 * t :], col.astype(np.float32))
    h = jax_hilbert(t)
    idx = (np.arange(t)[:, None] - np.arange(t)[None, :]) % t
    np.testing.assert_allclose(col[idx], h, rtol=0, atol=1e-12)
    assert np.count_nonzero(gain) == t - 1 - (t % 2 == 0)  # 0 at DC and Nyquist


@pytest.mark.parametrize("t", [256, 625, 1250])
def test_round_trip_gain_removes_the_constants_bias(t):
    """The FFT's part in exact arithmetic with the kernel's float32
    constants, against the same with exact constants: its component along
    itself (the bias the pair sums add up over T) is about 4e-8 to 7e-8,
    and round_trip_gain takes it below 1e-12."""
    eye = np.eye(t)
    exact = _fft_part(eye)
    for calibrated, low, high in ((False, 3e-8, 1e-7), (True, 0.0, 1e-12)):
        got = _fft_part(eye, np.complex128, calibrated, np.float32)
        bias = abs(np.sum((got - exact) * exact) / np.sum(exact * exact))
        assert low <= bias <= high


def _cos_sin_2phi(re, im):
    re2, im2 = re * re, im * im
    p2 = re2 + im2
    dead = p2 < np.finfo(np.float32).tiny
    inv = np.float32(1.0) / np.where(dead, np.float32(1.0), p2)
    return np.where(dead, 1.0, (re2 - im2) * inv), np.where(dead, 0.0, (2 * re * im) * inv)


def _kernel_walk(x):
    """The kernel's float32 arithmetic in numpy for windows x [B, T, C]:
    the calibrated FFT part in complex64 and the near taps, then for the
    samples with |z|^2 below kRefineBelow of the series' mean x^2 the dense
    float32 product (an FMA chain over the circulant column on the card;
    the twin's own product here), c2/s2 in float32, the sums rounded once."""
    batch, t, _ = x.shape
    series = x.transpose(0, 2, 1).reshape(-1, t)
    im = _hilbert_step(series, np.complex64, calibrated=True)
    energy = (series.astype(np.float64) ** 2).mean(axis=1, keepdims=True).astype(np.float32)
    near = series * series + im * im < np.float32(REFINE_BELOW) * energy
    dense = np.einsum("tk,bkc->bct", jax_hilbert(t).astype(np.float32), x).reshape(-1, t)
    im = np.where(near, dense, im)
    c2, s2 = _cos_sin_2phi(series, im)
    c2 = c2.reshape(batch, C, t).astype(np.float64)
    s2 = s2.reshape(batch, C, t).astype(np.float64)
    got = (np.einsum("bit,bjt->bij", c2, c2) + np.einsum("bit,bjt->bij", s2, s2)).astype(np.float32)
    return got, near


@pytest.mark.parametrize("t, batch", [(625, 6), (97, 24)])
def test_float32_walk_with_direct_sum_near_zero_matches_twin(t, batch):
    """The kernel's float32 walk against the plain twin: within the card
    limit 2e-4, a dead channel's diagonal exactly T."""
    x = (np.random.default_rng(t + batch).standard_normal((batch, t, C)) * 40.0).astype(np.float32)
    x[0, :, 3] = 0.0
    got, near = _kernel_walk(x)
    want = ku.kuramoto_pair_sums_plain(torch.from_numpy(x)).numpy()
    assert near.any()
    assert np.abs(got - want).max() <= 2e-4
    assert got[0, 3, 3] == float(t)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("t", [625, 1250])
def test_float32_walk_against_float64_within_twice_the_twin(t, seed):
    """One window, where a few samples near z = 0 set the error: the
    kernel's float32 walk is at most twice as far from float64 as the
    float32 twin (the card check's ratio). The FFT's rounding does not
    shrink with |z| as the dense product's does: with the whole operator
    in the FFT one window read 3.1x on the card (T = 1250)."""
    x = (np.random.default_rng(1000 * t + seed).standard_normal((1, t, C)) * 40.0).astype(np.float32)
    got, _ = _kernel_walk(x)
    xt = torch.from_numpy(x)
    twin = ku.kuramoto_pair_sums_plain(xt).numpy().astype(np.float64)
    exact = ku.kuramoto_pair_sums_plain(xt.double()).numpy()
    assert np.abs(got - exact).max() <= 2.0 * np.abs(twin - exact).max()


# ------------------------------------------------------- rational features
def _permuted(a):
    """The kernels' basis: the channels of the [C, C] a in ascending order
    of its diagonal, and that order."""
    perm = np.argsort(np.diag(a), kind="stable")
    return a[np.ix_(perm, perm)], perm


def _householder(a):
    """csrc/sym8_eigen.cuh tridiagonalize on the float64 [C, C] a: T's
    diagonal d and off-diagonal e (float64) and the 6 reflectors (v
    zero-padded to C, beta), float64."""
    a = a.astype(np.float64)
    hv, hb = [], []
    e = np.zeros(C - 1)
    for k in range(C - 2):
        x = a[k + 1 :, k].copy()
        sigma = np.sum(x[1:] * x[1:])
        reflect = sigma > 0
        alpha = -np.copysign(np.sqrt(x[0] * x[0] + sigma), x[0]) if reflect else x[0]
        v = x.copy()
        v[0] = x[0] - alpha
        beta = 2.0 / (v[0] * v[0] + sigma) if reflect else 0.0
        e[k] = alpha
        blk = a[k + 1 :, k + 1 :]
        p = beta * (blk @ v)
        w = p - 0.5 * beta * (p @ v) * v
        a[k + 1 :, k + 1 :] = blk - np.outer(v, w) - np.outer(w, v)
        full = np.zeros(C)
        full[k + 1 :] = v
        hv.append(full)
        hb.append(beta)
    e[C - 2] = a[C - 1, C - 2]
    return np.diag(a).copy(), e, hv, hb


def _back_transform(r, hv, hb, dtype):
    """r <- Q r Q^T by the reflectors rounded to `dtype`, in `dtype`."""
    f = np.dtype(dtype).type
    for k in range(C - 3, -1, -1):
        v, beta = hv[k].astype(dtype), f(hb[k])
        p = (beta * (r @ v)).astype(dtype)
        w = (p - f(f(0.5) * beta * f(p @ v)) * v).astype(dtype)
        r = (r - np.outer(v, w) - np.outer(w, v)).astype(dtype)
    return r


def _tridiagonal_route(s, c0, poles, weights, dtype):
    """log of the SPD [C, C] s in `dtype` by the kernel's step 3: A = s (1 /
    (tr s / C)), its channels put in ascending order of the diagonal; 6
    Householder reflectors (T = Q^T A Q) in float64, T and the reflectors
    then rounded to `dtype`; for each pole the bottom-up
    pivots D_i of T - p I, rho_i = -e_{i-1} / D_i, M_jj = 1 / D_j + rho_j^2
    M_{j-1,j-1}, M_ij = rho_i M_{i-1,j}; Q R Q^T, back in the channels'
    order; + c0 I; + log(tr / C) I."""
    f = np.dtype(dtype).type
    s = s.astype(dtype)
    tr2 = _trace_over_c(s)
    a, perm = _permuted((s * f(f(1.0) / tr2)).astype(dtype))
    d, e, hv, hb = _householder(a)
    d = d.astype(dtype)
    e = e.astype(dtype)
    r = np.zeros((C, C), dtype)
    for pole, weight in zip(poles, weights):
        pole, weight = f(pole), f(weight)
        inv = np.zeros(C, dtype)
        inv[C - 1] = f(1.0) / f(d[C - 1] - pole)
        for i in range(C - 2, -1, -1):
            inv[i] = f(1.0) / f(f(d[i] - pole) - e[i] * e[i] * inv[i + 1])
        rho = np.zeros(C, dtype)
        rho[1:] = -e * inv[1:]
        m = np.zeros((C, C), dtype)
        mjj = inv[0]
        for j in range(C):
            if j:
                mjj = f(rho[j] * rho[j] * mjj + inv[j])
            m[j, j] = mjj
            for i in range(j + 1, C):
                m[i, j] = m[j, i] = f(rho[i] * m[i - 1, j])
        r = (r + weight * m).astype(dtype)
    r = _back_transform(r, hv, hb, dtype)
    back = np.argsort(perm)
    return r[np.ix_(back, back)] + (f(c0) + np.log(tr2)) * np.eye(C, dtype=dtype)


def _trace_over_c(s):
    """tr(s) / C, the diagonal summed in index order in s's dtype."""
    f = s.dtype.type
    tr = s[0, 0]
    for i in range(1, C):
        tr = f(tr + s[i, i])
    return f(tr / f(C))


def _flagship_spd(n, seed, cold):
    """Shrunk band covariances as the flagship builds them: (1 - a) G + a
    (tr G / C) W W^T, a = the model's shrinkage; `cold` cuts one whitener
    gain tenfold (a spectrum edge near lo); guarded as the twin guards."""
    cfg = logcov.LogCovConfig()
    lo, hi = cfg.cheb_interval
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, C, 80))
    g = y @ y.transpose(0, 2, 1)
    w = np.eye(C) + 0.3 * rng.standard_normal((n, C, C))
    if cold:
        w[:, 5] *= 0.1
    wwt = w @ w.transpose(0, 2, 1)
    tr = np.trace(g, axis1=1, axis2=2)[:, None, None]
    s = (1.0 - cfg.shrinkage) * g + cfg.shrinkage * (tr / C + 1e-12) * wwt
    s, _ = spd.guard_spectrum(torch.from_numpy(s), lo, hi, logcov._guard_strength(cfg))
    return s.numpy(), lo, hi


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("terms", [1, 4, 12, 32])
def test_tridiagonal_route_float64_is_logm_rational(cold, terms):
    """float64: the route = spd.logm_rational (the twin's Gauss-Jordan
    resolvent sum) to 1e-9, on in-domain SPD matrices."""
    s, lo, hi = _flagship_spd(24, terms + 10 * cold, cold)
    c0, poles, weights = logcov._rational_log_coeffs(lo, hi, terms)
    want = spd.logm_rational(torch.from_numpy(s), c0, poles, weights).numpy()
    for m in range(s.shape[0]):
        got = _tridiagonal_route(s[m], c0, poles, weights, np.float64)
        assert np.abs(got - want[m]).max() <= 1e-9


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("terms", [4, 12, 32])
def test_tridiagonal_route_float32_within_twin(cold, terms):
    """float32: within 5e-5 of the float32 twin (the card limit), of
    float64 at least as close as 5e-5 too, and against float64 at most
    twice the twin's largest error (the card check's ratio)."""
    s, lo, hi = _flagship_spd(24, 100 + terms + cold, cold)
    s32 = s.astype(np.float32)
    c0, poles, weights = logcov._rational_log_coeffs(lo, hi, terms)
    twin = spd.logm_rational(torch.from_numpy(s32), c0, poles, weights).numpy()
    exact = spd.logm_rational(torch.from_numpy(s32.astype(np.float64)), c0, poles, weights).numpy()
    worst = 0.0
    for m in range(s.shape[0]):
        got = _tridiagonal_route(s32[m], c0, poles, weights, np.float32)
        assert got.dtype == np.float32
        assert np.abs(got - twin[m]).max() <= 5e-5
        assert np.abs(got - exact[m]).max() <= 5e-5
        worst = max(worst, np.abs(got - exact[m]).max())
    assert worst <= 2.0 * np.abs(twin - exact).max()


# ------------------------------------------- Chebyshev series (both kernels)
MAX_SWEEPS = 30  # csrc/sym8_eigen.cuh kMaxSweeps


def _ql(d, e, zdtype):
    """csrc/sym8_eigen.cuh tridiagonal_eigen: the implicit-shift QL
    iteration (tqli) on the float64 tridiagonal (d, e), the rotations
    accumulated into Z in `zdtype`; at most MAX_SWEEPS sweeps an
    eigenvalue. Returns the eigenvalues (in no order), Z and the sweeps."""
    d = [float(x) for x in d]
    e = [float(x) for x in e] + [0.0]
    f = np.dtype(zdtype).type
    z = np.eye(C, dtype=zdtype)
    sweeps = 0
    for l in range(C - 1):
        for _ in range(MAX_SWEEPS):
            m = C - 1
            for j in range(C - 2, l - 1, -1):
                dd = abs(d[j]) + abs(d[j + 1])
                if abs(e[j]) + dd == dd:
                    m = j
            if m == l:
                break
            sweeps += 1
            g = (d[l + 1] - d[l]) / (2.0 * e[l])
            r = math.sqrt(g * g + 1.0)
            g = d[m] - d[l] + e[l] / (g + math.copysign(r, g))
            s = c = 1.0
            p = 0.0
            underflow = False
            for i in range(C - 2, l - 1, -1):
                if i >= m or underflow:
                    continue
                fi, b = s * e[i], c * e[i]
                r2 = fi * fi + g * g
                if r2 == 0.0:
                    e[i + 1] = 0.0
                    d[i + 1] -= p
                    underflow = True
                    continue
                inv_r = 1.0 / math.sqrt(r2)
                e[i + 1] = r2 * inv_r
                s, c = fi * inv_r, g * inv_r
                g = d[i + 1] - p
                r = (d[i] - g) * s + 2.0 * c * b
                p = s * r
                d[i + 1] = g + p
                g = c * r - b
                zi, zi1 = z[:, i].copy(), z[:, i + 1].copy()
                z[:, i + 1] = f(s) * zi + f(c) * zi1
                z[:, i] = f(c) * zi - f(s) * zi1
            if not underflow:
                d[l] -= p
                e[l] = g
            e[m] = 0.0
    return np.array(d), z, sweeps


def _series(x, coeffs):
    """csrc/sym8_eigen.cuh chebyshev_series: sum_k c_k T_k(x) at each x by
    the scalar Clenshaw recurrence, in x's dtype."""
    f = x.dtype.type
    b1, b2 = np.zeros_like(x), np.zeros_like(x)
    for ck in coeffs[:0:-1]:
        b1, b2 = (f(ck) - b2) + f(2.0) * x * b1, b1
    return (f(coeffs[0]) - b2) + x * b1


def _eigen_route(a, coeffs, shift, scale, mixed):
    """csrc/sym8_eigen.cuh chebyshev_sym8: sum_k c_k T_k(X), X = (2 A -
    shift I) scale, of the symmetric [C, C] a: its channels in ascending
    order of the diagonal, the Householder tridiagonal form and QL in
    float64, the series at X's eigenvalues in float64, r = Z diag(p - pm)
    Z^T, Q r Q^T, then pm = (min p + max p) / 2 on the diagonal, back in
    the channels' order. `mixed`: the kernels' precisions (coefficients,
    Z, r and the reflectors in float32, the rest in float64); else all
    float64. (With the series in float32 too, test_eigen_route_edge_cases
    fails its float64 ratio for an eigenvalue at lo at degree 7.) Returns
    the result and the QL sweeps."""
    rdtype = np.float32 if mixed else np.float64
    cs = np.asarray(coeffs, np.float32 if mixed else np.float64).astype(np.float64)
    a, perm = _permuted(a)
    d, e, hv, hb = _householder(a)
    lam, z, sweeps = _ql(d, e, rdtype)
    p = _series((2.0 * lam - shift) * scale, cs)
    pm = 0.5 * (p.min() + p.max())
    zp = z * (p - pm).astype(rdtype)[None, :]
    r = _back_transform((zp @ z.T).astype(rdtype), hv, hb, rdtype)
    r = r + rdtype(pm) * np.eye(C, dtype=rdtype)
    back = np.argsort(perm)
    return r[np.ix_(back, back)], sweeps


def _features_route(s, coeffs, lo, hi, mixed):
    """The feature kernel's step 3 in Chebyshev mode: A = s (1 / (tr s /
    C)) in s's precision, the series of (2 A - (hi + lo) I) / (hi - lo)
    with the map in float64, + log(tr / C) I."""
    dtype = np.float32 if mixed else np.float64
    s = s.astype(dtype)
    f = np.dtype(dtype).type
    tr2 = _trace_over_c(s)
    a = (s * f(f(1.0) / tr2)).astype(dtype)
    r, sweeps = _eigen_route(a, coeffs, hi + lo, 1.0 / (hi - lo), mixed)
    return r + np.log(tr2).astype(dtype) * np.eye(C, dtype=dtype), sweeps


def _clenshaw_route(s, coeffs, lo, hi, mixed):
    """The Clenshaw kernel behind its wrapper: t = spd.chebyshev_domain_map
    of s (plain PyTorch, in s's precision), the series of t (shift 0,
    scale 1/2), + log(tr / C) I."""
    dtype = np.float32 if mixed else np.float64
    t, tr = spd.chebyshev_domain_map(torch.from_numpy(s.astype(dtype)), lo, hi)
    r, sweeps = _eigen_route(t.numpy(), coeffs, 0.0, 0.5, mixed)
    return r + np.log(tr.numpy()) * np.eye(C, dtype=dtype), sweeps


ROUTES = {"features": _features_route, "clenshaw": _clenshaw_route}


def _unwhitened_spd(n):
    """Unwhitened logcov8 band covariances (the stages path's input to the
    Clenshaw kernel) of golden filtered windows: in the domain by the
    shrinkage floor."""
    cfg = get_model("logcov8").config
    with np.load(REPO / "tests" / "golden" / "reference_filtered.npz", allow_pickle=False) as zf:
        x = zf["filtered"][: -(-n // len(cfg.bands))].astype(np.float32)
    s = logcov.band_covariances(torch.from_numpy(x), cfg).reshape(-1, C, C).numpy()
    assert s.shape[0] >= n
    return s[:n].astype(np.float64), *cfg.cheb_interval


def _spd_set(name, n, seed):
    if name == "unwhitened":
        return _unwhitened_spd(n)
    return _flagship_spd(n, seed, name == "cold")


def _cheb_coeffs(lo, hi, degree=None):
    return logcov._cheb_log_coeffs(lo, hi, logcov.LogCovConfig().cheb_degree if degree is None else degree)


def _scale(x):
    """Each matrix's max(|x|, 1): the card limit's scale."""
    return np.maximum(np.abs(x).max(axis=(-2, -1), keepdims=True), 1.0)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("spd_set", ["warm", "cold", "unwhitened"])
def test_eigen_route_float64_is_logm_chebyshev(route, spd_set):
    """float64: the eigendecomposition route = spd.logm_chebyshev (the
    twins' matrix Clenshaw recurrence) in float64 to 1e-9, degree 320, on
    the flagship's shrunk matrices and the unwhitened band covariances;
    every matrix ends within 19 QL sweeps."""
    s, lo, hi = _spd_set(spd_set, 16, 3)
    coeffs = _cheb_coeffs(lo, hi)
    want = spd.logm_chebyshev(torch.from_numpy(s), coeffs, lo, hi).numpy()
    for m in range(s.shape[0]):
        got, sweeps = ROUTES[route](s[m], coeffs, lo, hi, mixed=False)
        assert np.abs(got - want[m]).max() <= 1e-9
        assert sweeps <= 19


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("spd_set", ["warm", "cold", "unwhitened"])
def test_eigen_route_mixed_precision_within_twin(route, spd_set):
    """The kernels' precisions: within 5e-5 of the float32 twin (the card
    limit), and against float64 at most twice the twin's largest error
    (the card check's ratio)."""
    s, lo, hi = _spd_set(spd_set, 24, 11)
    s32 = s.astype(np.float32)
    coeffs = _cheb_coeffs(lo, hi)
    twin = spd.logm_chebyshev(torch.from_numpy(s32), coeffs, lo, hi).numpy()
    exact = spd.logm_chebyshev(torch.from_numpy(s32.astype(np.float64)), coeffs, lo, hi).numpy()
    got = np.stack([ROUTES[route](s32[m], coeffs, lo, hi, mixed=True)[0] for m in range(s.shape[0])])
    assert got.dtype == np.float32
    assert np.abs(got - twin).max() <= 5e-5
    assert np.abs(got - exact).max() <= 2.0 * np.abs(twin - exact).max()


def _edge_spd(case, route, lo):
    """Four [C, C] matrices of each edge case, float64."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(4, C, C)))
    lam = rng.uniform(0.3, 3.0, size=(4, C))
    if case == "identity":
        return np.stack([c * np.eye(C) for c in (1.0, 3.7, 1e-3, 1e6)])
    if case == "zero_window":
        cfg = logcov.LogCovConfig()
        if route == "clenshaw":  # the stages path: the shrinkage floor of a zero covariance
            return np.stack([cfg.shrinkage * 1e-12 * np.eye(C)] * 4)
        # the feature kernel's: s = a (0 / C + 1e-12) W W^T under the smoke's
        # whitener (channel 5's gain cut tenfold), then the guard
        w = load_params_npz(REPO / "checkpoints" / "logcov8wd_ens_s0.npz")["whitener"][:4]
        w = w * np.where(np.arange(C) == 5, 0.1, 1.0)[None, None, :]
        wwt = np.einsum("kij,klj->kil", w, w).astype(np.float32)
        s = cfg.shrinkage * (0.0 / C + 1e-12) * torch.from_numpy(wwt)
        s, _ = spd.guard_spectrum(s, *cfg.cheb_interval, logcov._guard_strength(cfg))
        return s.double().numpy()
    if case == "split":  # two eigenvalues 1e-7 apart (relative)
        lam[:, 1] = lam[:, 0] * (1.0 + 1e-7)
    if case == "at_lo":  # trace-normalised, the smallest eigenvalue at lo
        lam = lam / lam.sum(axis=1, keepdims=True) * C * (1.0 - lo / C)
        lam[:, 0] = lo
    return np.einsum("mij,mj,mkj->mik", q, lam, q)


@pytest.mark.parametrize("degree", [0, 1, 2, 7, 320])
@pytest.mark.parametrize("case", ["identity", "zero_window", "split", "at_lo"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_eigen_route_edge_cases(route, case, degree):
    """Multiples of the identity (no reflector, no QL sweep), the smoke's
    all-zero window after the guard, two eigenvalues 1e-7 apart, an
    eigenvalue at lo; degrees 0 (c_0 I exactly), 1, 2, 7 and 320. float64:
    = spd.logm_chebyshev in float64 to 1e-9 of each matrix's max(|log|, 1).
    Kernel precisions: within 5e-5 of the float32 twin (of each matrix's
    max(|log|, 1) for the feature kernel, whose map onto the domain is
    float64 where the twin's is float32: about 1e-4 near lo), and against
    float64 at most twice the twin's error."""
    lo, hi = logcov.LogCovConfig().cheb_interval
    s = _edge_spd(case, route, lo)
    s32 = s.astype(np.float32)
    coeffs = _cheb_coeffs(lo, hi, degree)
    want64 = spd.logm_chebyshev(torch.from_numpy(s), coeffs, lo, hi).numpy()
    twin = spd.logm_chebyshev(torch.from_numpy(s32), coeffs, lo, hi).numpy()
    exact = spd.logm_chebyshev(torch.from_numpy(s32.astype(np.float64)), coeffs, lo, hi).numpy()
    got64 = np.stack([ROUTES[route](m, coeffs, lo, hi, mixed=False)[0] for m in s])
    got = np.stack([ROUTES[route](m, coeffs, lo, hi, mixed=True)[0] for m in s32])
    assert np.all((np.abs(got64 - want64) / _scale(want64)) <= 1e-9)
    limit = 5e-5 * (_scale(twin) if route == "features" else 1.0)
    assert np.all(np.abs(got - twin) <= limit)
    assert np.abs(got - exact).max() <= 2.0 * np.abs(twin - exact).max()
    if degree == 0:
        np.testing.assert_array_equal(got - np.diagonal(got, axis1=1, axis2=2)[:, :, None] * np.eye(C),
                                      np.zeros_like(got))


def test_eigen_route_nan_ends_in_bounded_sweeps():
    """A NaN entry is never negligible: its QL runs to the cap (7 x 30
    sweeps) and ends, with a non-finite result."""
    lo, hi = logcov.LogCovConfig().cheb_interval
    s = _edge_spd("split", "features", lo)[0].astype(np.float32)
    s[3, 3] = np.nan
    got, sweeps = _features_route(s, _cheb_coeffs(lo, hi, 7), lo, hi, mixed=True)
    assert sweeps == (C - 1) * MAX_SWEEPS
    assert not np.isfinite(got).any()


def test_sweep_cap_matches_the_kernel_source():
    source = (Path(__file__).resolve().parents[1] / "neural_speech_decoding_tpu_torch" / "csrc"
              / "sym8_eigen.cuh").read_text()
    assert f"constexpr int kMaxSweeps = {MAX_SWEEPS};" in source


# ------------------------------------------------------------- IIR cascade
IIR_SOURCE = (REPO / "neural_speech_decoding_tpu_torch" / "csrc" / "iir_cascade.cu").read_text()
READ_AHEAD = int(re.search(r"constexpr int kReadAhead = (\d+);", IIR_SOURCE).group(1))
# H100 80GB HBM3: SMs and opt-in shared memory a block, as
# torch.cuda.get_device_properties reads them (chip_smoke.py phase 3c prints them)
H100 = (132, 232448)
LANES = (1, 2, 4, 8, 16)  # every G the kernel takes
IIR_SOS = iir.stack_sos(iir.collector_stages())  # the collector's 14 sections


def _iir_sos(sections):
    return np.ascontiguousarray(np.concatenate([IIR_SOS] * 3)[:sections])


def _lane_pipeline(series, sos, lanes, k):
    """One launch's arithmetic on series [n, T] float32, the kernel's
    schedule step by step with K = k slots a lane: slot j of lane g holds
    section g K + j (identity past the last) and at step i runs it on
    sample i - (g K + j); the
    samples of a chunk of READ_AHEAD steps are read at the end of the chunk
    two before it (past the series: the pass's first sample), the last
    lane writes in place depth = G K - 1 steps behind. Products and sums
    rounded one by one, as the CPU twin computes them."""
    n, t_len = series.shape
    s_count = sos.shape[0]
    coef = np.tile(np.array([1, 0, 0, 0, 0], np.float32), (lanes * k, 1))
    coef[:s_count] = sos[:, [0, 1, 2, 4, 5]].astype(np.float32)
    b0, b1, b2, a1, a2 = (coef[:, q].reshape(lanes, k) for q in range(5))
    buf = series.copy()  # the tile: both passes in place
    depth = lanes * k - 1
    steps = t_len + depth
    for reverse in (False, True):
        at = (lambda i: t_len - 1 - i) if reverse else (lambda i: i)
        o, z0, z1 = (np.zeros((n, lanes, k), np.float32) for _ in range(3))
        ahead = [[buf[:, at(u)].copy() if u < t_len else np.zeros(n, np.float32) for u in range(q, q + READ_AHEAD)]
                 for q in (0, READ_AHEAD)]
        for i0 in range(0, steps, READ_AHEAD):
            cur = ahead.pop(0)
            for u in range(READ_AHEAD):
                y = np.roll(o[:, :, k - 1], 1, axis=1)  # __shfl_up_sync: lane g takes lane g - 1's
                y[:, 0] = cur[u]  # the head takes its sample
                inp = np.concatenate([y[:, :, None], o[:, :, :-1]], axis=2)  # slot j takes slot j - 1's
                o = b0 * inp + z0
                z0 = b1 * inp - a1 * o + z1
                z1 = b2 * inp - a2 * o
                p = i0 + u - depth
                if 0 <= p < t_len:
                    buf[:, at(p)] = o[:, lanes - 1, k - 1]
            ahead.append([buf[:, at(i if i < t_len else 0)].copy()
                          for i in range(i0 + 2 * READ_AHEAD, i0 + 3 * READ_AHEAD)])
    return buf


def _iir_kernel_walk(x_btc, sos, lanes, k, windows):
    """The launch over x [B, T, C]: blocks of `windows` whole windows, the
    last padded with NaN windows that no result is taken from, every
    (window, channel) series through the lane pipeline."""
    b, t_len, c = x_btc.shape
    blocks = -(-b // windows)
    tiles = np.full((blocks * windows, t_len, c), np.nan, np.float32)
    tiles[:b] = x_btc
    out = _lane_pipeline(tiles.transpose(0, 2, 1).reshape(-1, t_len), sos, lanes, k)
    return out.reshape(blocks * windows, c, t_len).transpose(0, 2, 1)[:b]


@functools.lru_cache(maxsize=None)
def _iir_case(sections, t_len):
    """Detrended windows [3, t_len, 5], one NaN series, and the CPU twin's
    cascade of them."""
    rng = np.random.default_rng(sections * 1000 + t_len)
    x = (rng.standard_normal((3, t_len, 5)) * 40.0).astype(np.float32)
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)
    x[1, t_len // 2, 2] = np.nan
    twin = iir.iir_cascade_plain(torch.from_numpy(x), _iir_sos(sections)).numpy()
    return x, twin


def test_iir_constants_match_the_kernel_source():
    for name, value in (("kMaxSections", iir.MAX_SECTIONS), ("kMaxSlots", iir.MAX_SLOTS),
                        ("kMaxLanes", iir.MAX_LANES), ("kMaxThreads", iir.MAX_THREADS)):
        assert f"constexpr int {name} = {value};" in IIR_SOURCE
    assert f"constexpr int kSlotCounts[] = {{{', '.join(map(str, iir.SLOT_COUNTS))}}};" in IIR_SOURCE
    assert iir.SLOT_COUNTS[-1] == iir.MAX_SLOTS
    assert READ_AHEAD >= 1


@pytest.mark.parametrize("t_len", [1, 2, 17, 625])
@pytest.mark.parametrize("sections", [1, 5, 14, 32])
@pytest.mark.parametrize("lanes", LANES)
def test_iir_lane_pipeline_is_the_twin_bit_for_bit(lanes, sections, t_len):
    """3 windows of 5 channels in blocks of the staged shape's W for a
    large batch (W = 32, or 18 at T = 625, and 16, 8, 4, 2 for G = 1 ..
    16), so the last block is partly empty; K the kernel's instantiation,
    with identity slots where it exceeds ceil(S / G). With 32 sections
    G = 1 is refused (K = 32 > 16) but walked at K = 32, W = 8 all the
    same. The NaN stays in its series."""
    x, twin = _iir_case(sections, t_len)
    if -(-sections // lanes) > iir.MAX_SLOTS:
        with pytest.raises(ValueError, match="lanes"):
            iir._shape(True, lanes, 1000, t_len, 5, sections, H100[1])
        k, windows = sections, 8
    else:
        plan = iir._shape(True, lanes, 1000, t_len, 5, sections, H100[1])
        assert plan.staged and plan.lanes == lanes
        k, windows = iir.slots(sections, lanes), plan.windows
        assert k >= -(-sections // lanes) and lanes * k <= 32
    assert 3 % windows != 0  # the last block partly empty
    got = _iir_kernel_walk(x, _iir_sos(sections), lanes, k, windows)
    assert np.array_equal(got, twin, equal_nan=True)
    assert np.isnan(got[1, :, 2]).all() and np.isfinite(np.delete(got.reshape(-1, 5), 2, axis=1)).all()


@pytest.mark.parametrize(
    "batch, staged, lanes, windows, blocks, threads",
    [(1, True, 2, 1, 1, 32), (37, True, 2, 2, 19, 32), (1024, True, 2, 2, 512, 32),
     (2048, True, 2, 2, 1024, 32), (3072, False, 1, 0, 96, 256), (16384, False, 1, 0, 512, 256)],
)
def test_iir_launch_plan_on_an_h100(batch, staged, lanes, windows, blocks, threads):
    """The rule at T = 625, C = 8, 14 sections: staged (G = 2, W the fewest
    windows that fill whole warps) below 128 series an SM, in global memory
    (G = 1, 256 series a block) from there; 2048 and 3072 windows are the
    measured batches either side of the switch. Groups stay inside warps
    and blocks inside the card's limits."""
    plan = iir.launch_plan(batch, 625, 8, 14, *H100)
    assert (plan.staged, plan.lanes, plan.windows, plan.blocks, plan.threads) == (
        staged, lanes, windows, blocks, threads)
    assert plan.shared_bytes == windows * 625 * 8 * 4
    assert 32 % plan.lanes == 0 and plan.threads % 32 == 0 and plan.threads <= iir.MAX_THREADS
    assert plan.block_series * plan.lanes <= plan.threads and plan.blocks * plan.block_series >= batch * 8
    assert plan.shared_bytes + iir.STATIC_SMEM <= H100[1]


@pytest.mark.parametrize("batch", [1, 37, 1024, 16384])
def test_iir_tile_reads_free_of_bank_conflicts(batch):
    """Lane 0 of each group reads word (w T + i) C + c of the tile and the
    last lane writes the same word: within a warp the 32 / G groups' words
    fall on distinct banks at T = 625, C = 8, for every G."""
    for g in LANES:
        plan = iir._shape(True, g, batch, 625, 8, 14, H100[1])
        series = np.arange(plan.block_series)
        words = (series // 8) * 625 * 8 + series % 8  # sample 0; sample i shifts every word by 8 i
        warp_of = series * g // 32
        for w in np.unique(warp_of):
            banks = words[warp_of == w] % 32
            assert len(set(banks)) == len(banks), (g, w)


@pytest.mark.parametrize("t_len, staged", [(7263, True), (7264, False), (20000, False)])
def test_iir_plan_at_the_edge_of_shared_memory(t_len, staged):
    """One window at C = 8 stages while its tile and the kernel's own 16
    bytes fit a block's opt-in shared memory (7263 samples: 232416 + 16 <=
    232448 B), else runs in place in global memory, whose G is 1 up to 16
    sections and 2 past them; forced to stage, a tile that does not fit
    is refused, as are 33 sections."""
    plan = iir.launch_plan(1, t_len, 8, 14, *H100)
    assert plan.staged == staged and plan.shared_bytes == (4 * t_len * 8 if staged else 0)
    if not staged:
        assert plan.lanes == 1 and iir.launch_plan(1, t_len, 8, 32, *H100).lanes == 2
        with pytest.raises(ValueError, match="fit"):
            iir._shape(True, 2, 1, t_len, 8, 14, H100[1])
    with pytest.raises(ValueError, match="limit"):
        iir.launch_plan(1, t_len, 8, 33, *H100)


# ------------------------------------------------------ band grams (DMMA)
GRAMS_SOURCE = (REPO / "neural_speech_decoding_tpu_torch" / "csrc" / "bandcov_grams.cu").read_text()
GRAMS_UNROLL = int(re.search(r"constexpr int kUnroll = (\d+);", GRAMS_SOURCE).group(1))
LANE = np.arange(32)
IU, JU = np.triu_indices(C)


def _family_offsets(name):
    _, slices = logcov._band_projector(625, get_model(name).config)
    return logcov._band_offsets(slices)


def _random_offsets(seed, nb=16):
    """nb bands of 0 to 13 rows (empty, 1-3 rows and widths that are not
    multiples of 4 among them), starting after row 0 and ending before the
    last row."""
    widths = np.random.default_rng(seed).integers(0, 14, nb)
    widths[:4] = (0, 1, 2, 3)
    return tuple(int(o) for o in 3 + np.concatenate([[0], np.cumsum(widths)]))


GRAM_LAYOUTS = {
    "logcov5": _family_offsets("logcov5"),
    "logcov8": _family_offsets("logcov8"),
    "logcov12": _family_offsets("logcov12"),
    "random16": _random_offsets(0),
    "random16b": _random_offsets(1),
}


def _pair_of_lane(lane, i):
    """The accumulator element lane holds as its i-th double (D[l / 4][2 (l % 4) + i])
    and the pair it writes, or None below the diagonal."""
    c, d = lane // 4, 2 * (lane % 4) + i
    return (c, d, c * (15 - c) // 2 + d) if d >= c else (c, d, None)


def _dmma_walk(y, offsets):
    """The kernel's arithmetic on y [B, R, 8] float32: a warp a (window,
    band); the band in 4-row chunks, kUnroll chunks loaded before their
    DMMAs, lanes past the band's end loading 0 and chunks wholly past it
    skipped; lane l loads Y[r0 + l % 4][l / 4] as both its A (row l / 4,
    column l % 4 of Y^T) and its B (row l % 4, column l / 4 of Y) element,
    widened to float64; D += A B in float64. Returns the float64
    accumulators at the pairs' places [B, nb * 36] and the DMMAs a window."""
    batch, rows, _ = y.shape
    nb = len(offsets) - 1
    flat = y.reshape(batch, -1)
    out = np.full((batch, nb * 36), np.nan)
    dmmas = 0
    for b in range(batch):
        for k in range(nb):
            lo, n = offsets[k], offsets[k + 1] - offsets[k]
            acc = np.zeros((8, 8))
            for r in range(0, n, 4 * GRAMS_UNROLL):
                for u in range(GRAMS_UNROLL):
                    r0 = r + 4 * u
                    if r0 >= n:  # warp-uniform skip
                        continue
                    addr = (lo + r0) * C + (LANE % 4) * C + LANE // 4
                    assert np.array_equal(np.sort(addr), (lo + r0) * C + np.arange(32))  # 128 contiguous bytes
                    live = r0 + LANE % 4 < n
                    v = np.where(live, flat[b, np.where(live, addr, 0)], np.float32(0)).astype(np.float64)
                    a = np.zeros((8, 4))
                    bm = np.zeros((4, 8))
                    a[LANE // 4, LANE % 4] = v
                    bm[LANE % 4, LANE // 4] = v
                    assert np.array_equal(a, bm.T)  # one value feeds both operands
                    acc = acc + a @ bm
                    dmmas += b == 0
            for lane in LANE:
                for i in (0, 1):
                    c, d, p = _pair_of_lane(lane, i)
                    if p is not None:
                        out[b, k * 36 + p] = acc[c, d]
    return out, dmmas


def _exact_grams(y, offsets):
    """The grams by math.fsum of the exact float64 products: correctly
    rounded float64."""
    yd = y.astype(np.float64)
    out = np.empty((y.shape[0], (len(offsets) - 1) * 36))
    for b in range(y.shape[0]):
        for k, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
            band = yd[b, lo:hi]
            prods = band[:, IU] * band[:, JU]  # [n, 36]
            out[b, k * 36:(k + 1) * 36] = [math.fsum(prods[:, p]) for p in range(36)]
    return out


def test_band_grams_constants_match_the_kernel_source():
    assert f"constexpr int kMaxBands = {bandcov.MAX_BANDS};" in GRAMS_SOURCE
    assert f"constexpr int kC = {bandcov.CHANNELS};" in GRAMS_SOURCE
    assert bandcov.MAX_ROWS == 1 << 26 and "constexpr int kMaxRows = 1 << 26;" in GRAMS_SOURCE
    assert "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64" in GRAMS_SOURCE
    assert GRAMS_UNROLL >= 1


def test_band_grams_lane_map_writes_every_pair_once():
    """The m8n8k4 f64 accumulator fragment (lane l: D[l / 4][2 (l % 4) + i])
    holds all 64 entries once, and the lanes on or above the diagonal
    write the 36 pairs once each, at the twin's row-major places."""
    held = {(lane // 4, 2 * (lane % 4) + i) for lane in LANE for i in (0, 1)}
    assert held == {(c, d) for c in range(8) for d in range(8)}
    written = [_pair_of_lane(lane, i) for lane in LANE for i in (0, 1)]
    pairs = sorted(p for _, _, p in written if p is not None)
    assert pairs == list(range(36))
    for c, d, p in written:
        if p is not None:
            assert (IU[p], JU[p]) == (c, d)


@pytest.mark.parametrize("layout", sorted(GRAM_LAYOUTS))
def test_band_grams_walk_float64_is_exact_on_integers(layout):
    """On integer rows every sum is exact in any order: the walk's float64
    accumulators equal the float64 twin's grams, and rounded to float32
    the float32 twin's, bit for bit."""
    offsets = GRAM_LAYOUTS[layout]
    rows = offsets[-1] + 2
    y = np.random.default_rng(5).integers(-8, 9, (3, rows, C)).astype(np.float32)
    got, _ = _dmma_walk(y, offsets)
    yt = torch.from_numpy(y)
    assert np.array_equal(got, bandcov.band_grams_plain(yt.double(), offsets).numpy())
    assert np.array_equal(got.astype(np.float32), bandcov.band_grams_plain(yt, offsets).numpy())


@pytest.mark.parametrize("layout", sorted(GRAM_LAYOUTS))
def test_band_grams_walk_float32_within_one_rounding(layout):
    """Gaussian rows with a railed window (x1e6) and an all-zero one: the
    walk's float64 sums of exact products, rounded once to float32, lie
    within one rounding (2^-24 |G|, plus the float64 sums' n 2^-53 of the
    window's max|G|) of the exact grams, so within 1.2e-7 of each window's
    max|G| (the card's limit), and within 1e-5 of it from the float32
    twin (the card's kernel-vs-twin limit)."""
    offsets = GRAM_LAYOUTS[layout]
    y = np.random.default_rng(6).standard_normal((4, offsets[-1] + 1, C)).astype(np.float32)
    y[0, :, 2] *= 1e6
    y[1] = 0.0
    acc, dmmas = _dmma_walk(y, offsets)
    got = acc.astype(np.float32)
    exact = _exact_grams(y, offsets)
    scale = np.abs(exact).max(axis=1, keepdims=True)
    assert scale[1, 0] == 0.0 and not got[1].any()
    scale[1] = 1.0
    assert (np.abs(acc - exact) <= 1e-12 * scale).all()
    assert (np.abs(got - exact) <= 2.0**-24 * np.abs(exact) + 1e-12 * scale).all()
    assert (np.abs(got - exact) / scale).max() <= 1.2e-7
    twin = bandcov.band_grams_plain(torch.from_numpy(y), offsets).numpy()
    assert (np.abs(got - twin) / scale).max() <= 1e-5
    widths = np.diff(offsets)
    assert dmmas == sum(-(-w // 4) for w in widths)
    if layout == "logcov8":
        assert dmmas == 114


def test_band_grams_wrapper_takes_autograd_only_for_a_gradient(monkeypatch):
    """The lean launch path: under no_grad, or for rows that need no
    gradient, the forward runs without the autograd Function and gives the
    twin's values; with a gradient wanted it goes through the Function, and
    the gradient is the twin's."""
    offsets = GRAM_LAYOUTS["logcov8"]
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((3, 450, C)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((3, 8 * 36)).astype(np.float32))
    want = bandcov.band_grams_plain(y, offsets)

    def refuse(*args):
        raise AssertionError("autograd Function entered")

    with monkeypatch.context() as m:
        m.setattr(bandcov._BandGrams, "apply", refuse)
        yg = y.clone().requires_grad_(True)
        with torch.no_grad():
            got = bandcov.band_grams(yg, offsets)
        assert torch.equal(got, want) and got.grad_fn is None
        assert torch.equal(bandcov.band_grams(y, list(offsets)), want)
    yg = y.clone().requires_grad_(True)
    got = bandcov.band_grams(yg, offsets)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)
    got.backward(ct)
    yt = y.clone().requires_grad_(True)
    bandcov.band_grams_plain(yt, offsets).backward(ct)
    assert torch.equal(yg.grad, yt.grad)


@pytest.mark.parametrize(
    "rows, offsets",
    [(450, (0,)), (450, tuple(range(18))), (450, (0, 30, 20, 450)), (450, (0, 30, 451)), (450, (-1, 30)),
     (bandcov.MAX_ROWS + 1, (0, 30))],
)
def test_band_grams_bad_layout_raises_after_a_good_one_is_cached(rows, offsets):
    """A layout is validated once and cached with its ctypes array; a bad
    one is never cached, so it raises on every call, before and after a
    good one was cached."""
    good = GRAM_LAYOUTS["logcov8"]
    y = torch.zeros((2, 450, C))
    bandcov.band_grams(y, good)
    hits = bandcov._plan.cache_info().hits
    bandcov.band_grams(y, good)
    assert bandcov._plan.cache_info().hits == hits + 1
    plan = bandcov._plan(450, good)
    assert plan.nb == 8 and plan.offsets == good and list(plan.c_offsets) == list(good)
    for _ in range(2):
        with pytest.raises(ValueError):
            if rows == 450:
                bandcov.band_grams(y, offsets)
            else:  # too many rows to allocate here: the layout check alone
                bandcov._plan(rows, offsets)
    assert bandcov.band_grams(y, good).shape == (2, 288)


def test_band_grams_rejects_bad_tensors_on_every_call():
    offsets = GRAM_LAYOUTS["logcov8"]
    y = torch.zeros((2, 450, C))
    bandcov.band_grams(y, offsets)
    for _ in range(2):
        with pytest.raises(TypeError):
            bandcov.band_grams(y.double(), offsets)
        with pytest.raises(TypeError):
            bandcov.band_grams(y.numpy(), offsets)
        with pytest.raises(ValueError):
            bandcov.band_grams(y[:, :, :4], offsets)
        with pytest.raises(ValueError):
            bandcov.band_grams(y.transpose(0, 1), offsets)
        with pytest.raises(ValueError, match="device"):
            bandcov.band_grams(y.to("meta"), offsets)
