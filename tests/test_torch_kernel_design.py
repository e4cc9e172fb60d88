"""The algorithms of the port's two redesigned CUDA kernels, walked in numpy
on the CPU, where no card runs them.

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
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.ops.hilbert import _hilbert_transform_matrix as jax_hilbert
from neural_speech_decoding_tpu_torch.models import logcov
from neural_speech_decoding_tpu_torch.ops import spd
from neural_speech_decoding_tpu_torch.ops.kernels import kuramoto as ku

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
    tr = s[0, 0]
    for i in range(1, C):
        tr = f(tr + s[i, i])
    tr2 = f(tr / f(C))
    a = (s * f(f(1.0) / tr2)).astype(dtype)
    perm = np.argsort(np.diag(a), kind="stable")
    a = a[np.ix_(perm, perm)].astype(np.float64)
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
        full = np.zeros(C, dtype)
        full[k + 1 :] = v
        hv.append(full)
        hb.append(f(beta))
    e[C - 2] = a[C - 1, C - 2]
    d = np.diag(a).astype(dtype)
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
    for k in range(C - 3, -1, -1):
        v, beta = hv[k], hb[k]
        p = (beta * (r @ v)).astype(dtype)
        w = (p - f(f(0.5) * beta * f(p @ v)) * v).astype(dtype)
        r = (r - np.outer(v, w) - np.outer(w, v)).astype(dtype)
    back = np.argsort(perm)
    return r[np.ix_(back, back)] + (f(c0) + np.log(tr2)) * np.eye(C, dtype=dtype)


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
