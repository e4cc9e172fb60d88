"""Fused Hilbert transform + Kuramoto pair sums: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
kuramoto.py:60 (_pair_sums_kernel, wrapper kuramoto_pair_sums:120). For raw
windows x [B, T, C] float32 it returns the symmetric gram sums

  G[b, i, j] = sum_t (c2_i c2_j + s2_i s2_j)                 [B, C, C]

with im = H x (the Hilbert transform of ops/hilbert.py), c2 = (x^2 -
im^2) / p2, s2 = 2 x im / p2, p2 = x^2 + im^2, and c2 = 1, s2 = 0 where
p2 < f32 tiny. The kernel (csrc/kuramoto_pair_sums.cu, built with plain
nvcc and bound with ctypes) runs for a CUDA tensor and does the Hilbert
step as the operator's nearest taps in the time domain plus an in-place
mixed-radix FFT round trip in shared memory for the rest, from the stage
plan and tables built here (fft_plan, fft_tables, round_trip_gain); the
plain twin,
the dense [T, T] operator, runs for a CPU tensor and is the kernel's test
oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.hilbert import _hilbert_gain, _hilbert_transform_matrix, hilbert_matrix
from neural_speech_decoding_tpu_torch.ops.kernels import build

NAME = "kuramoto_pair_sums"
CHANNELS = 8  # the kernel is specialised to the 8-channel headset
# Taps on each side of t that the kernel applies in the time domain (kNear
# in csrc/kuramoto_pair_sums.cu); the FFT carries the rest of the operator.
NEAR_TAPS = 3


def cos_sin_2phi(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Transcendental-free c2 = cos 2phi, s2 = sin 2phi of z = re + i im
    [..., T, C], with the degenerate-sample guard: where |z|^2 is below the
    dtype's tiny, c2 = 1 and s2 = 0 (np.angle(0) == 0)."""
    re2 = re * re
    im2 = im * im
    p2 = re2 + im2
    degenerate = p2 < torch.finfo(re.dtype).tiny
    inv = 1.0 / torch.where(degenerate, 1.0, p2)
    c2 = torch.where(degenerate, 1.0, (re2 - im2) * inv)
    s2 = torch.where(degenerate, 0.0, (2.0 * re * im) * inv)
    return c2, s2


def kuramoto_pair_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [B, T, C] float32 -> [B, C, C] float32. The
    pair products are summed over T by torch.sum, a tree reduction like the
    kernel's (a [C, 2T] x [2T, C] matmul sums 2T = 1250 terms in a running
    f32 sum, about 10x less accurate). Any float dtype: in float64 it is
    the kernel's accuracy reference."""
    h = hilbert_matrix(x.shape[1], x.device, x.dtype)
    c2, s2 = cos_sin_2phi(x, torch.matmul(h, x))
    prod = c2[..., :, None] * c2[..., None, :] + s2[..., :, None] * s2[..., None, :]
    return prod.sum(dim=1)  # [B, T, C, C] -> [B, C, C]


@functools.lru_cache(maxsize=64)
def fft_plan(t: int) -> Tuple[int, ...]:
    """Radices of the kernel's FFT stages for length t, in order (product
    t): the prime factors above 5 first, then 4s, a 2, 3s and 5s, so that
    the last stage, which the kernel fuses with the multiplier and the
    first inverse stage, has a fixed radix whenever t has a factor <= 5.
    625 -> (5, 5, 5, 5), 1250 -> (2, 5, 5, 5, 5), 256 -> (4, 4, 4, 4),
    97 -> (97,), 1 -> ()."""
    if t < 1:
        raise ValueError(f"window length must be positive, got {t}")
    small = {2: 0, 3: 0, 5: 0}
    for r in small:
        while t % r == 0:
            small[r] += 1
            t //= r
    large, p = [], 7
    while t > 1:
        while t % p == 0:
            large.append(p)
            t //= p
        p += 2
    twos = small[2]
    return (*large, *(4,) * (twos // 2), *(2,) * (twos % 2), *(3,) * small[3], *(5,) * small[5])


def fft_positions(t: int) -> np.ndarray:
    """pos[k]: where the kernel's in-place decimation-in-frequency stages
    leave frequency k (digit reversal over the plan's mixed radices). Stage
    s with sub-transform length L and radix r sends digit k_s of
    k = k_1 + r_1 (k_2 + r_2 (...)) to offset k_s L / r."""
    k = np.arange(t)
    pos = np.zeros(t, dtype=np.int64)
    length = t
    for r in fft_plan(t):
        length //= r
        pos += (k % r) * length
        k = k // r
    return pos


def near_taps(t: int) -> int:
    """Taps d = 1..near_taps(t) on each side, distinct modulo t."""
    return min(NEAR_TAPS, (t - 1) // 2)


@functools.lru_cache(maxsize=64)
def fft_tables(t: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float64 (twiddles, gain, column) of the kernel's Hilbert step for
    length t. H = N + F: N holds the float32 taps column[d] and
    column[t - d], d = 1..near_taps(t), of the operator's first column
    (H[t, k] = column[(t - k) mod t]), which the kernel sums in the time
    domain; F, the rest, is the FFT round trip. twiddles[m] = exp(-2 pi i
    m / t); gain[p] = ((h_k - 1) - mu_k) / t for the frequency k at
    position p = fft_positions(t)[k], h scipy's Hilbert gain and -i mu_k
    the eigenvalues of N, by which -i times the spectrum is multiplied (the
    inverse transform's 1/t folded in). Near z = 0 the kernel sums the
    whole column as the reference's dense product does."""
    twiddles = np.exp(-2j * np.pi * np.arange(t) / t)
    column = _hilbert_transform_matrix(t)[:, 0].copy()
    taps = near_taps(t)
    near = np.zeros(t)
    for d in range(1, taps + 1):
        near[d] = np.float32(column[d])
        near[t - d] = np.float32(column[t - d])
    mu = (1j * np.fft.fft(near)).real  # N is real and odd: its eigenvalues are imaginary
    mu[0] = 0.0  # and 0 at DC and Nyquist, where the FFT leaves rounding
    if t % 2 == 0:
        mu[t // 2] = 0.0
    gain = np.empty(t, dtype=np.float64)
    gain[fft_positions(t)] = (_hilbert_gain(t) - 1.0 - mu) / t
    for a in (twiddles, gain, column):
        a.flags.writeable = False
    return twiddles, gain, column


def _butterfly(r: int) -> np.ndarray:
    """The forward R-point butterfly (Dft<R, -1>, R = 2..5) as a matrix of
    the kernel's float32 constants."""
    c = lambda v: float(np.float32(v))  # noqa: E731
    if r == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.complex128)
    if r == 3:
        s = c(0.86602540378443864676)
        return np.array([[1, 1, 1], [1, -0.5 - 1j * s, -0.5 + 1j * s], [1, -0.5 + 1j * s, -0.5 - 1j * s]])
    if r == 4:
        return np.array([[1, 1, 1, 1], [1, -1j, -1, 1j], [1, -1, 1, -1], [1, 1j, -1, -1j]])
    c1, c2 = c(0.30901699437494742410), c(-0.80901699437494742410)
    s1, s2 = c(0.95105651629515357212), c(0.58778525229247312917)
    row1 = [1, c1 - 1j * s1, c2 - 1j * s2, c2 + 1j * s2, c1 + 1j * s1]
    row2 = [1, c2 - 1j * s2, c1 + 1j * s1, c1 - 1j * s1, c2 + 1j * s2]
    return np.array([[1] * 5, row1, row2, np.conj(row2), np.conj(row1)])


@functools.lru_cache(maxsize=16)
def round_trip_gain(t: int) -> np.ndarray:
    """c[p]: the factor on the multiplier at position p that takes the
    bias of the kernel's float32 constants out of its round trip. The
    inverse is the adjoint of the forward transform F~, so the round trip
    is F~^H D F~. With the butterflies' and twiddles' float32 constants,
    row p of F~ holds a_p = <f~_p, f_p> / t = 1 + O(eps) of the exact row
    f_p, alike for every butterfly of a stage, and the round trip scales
    frequency p by |a_p|^2: a bias of about 7e-8 of the FFT's part at
    radix 5, which the pair sums add up over t (on the card, -2e-6 in each
    G[i, j] of a dead channel i at t = 625). c = 1 / |a|^2, from F~ in
    float64; a direct-DFT stage is taken as exact (its table twiddles
    round at random, without bias)."""
    twiddles, _, _ = fft_tables(t)
    tw32 = twiddles.astype(np.complex64).astype(np.complex128)
    buf = np.eye(t, dtype=np.complex128)  # [impulse, position]
    length = t
    for r in fft_plan(t):
        m, step = length // r, t // length
        v = buf.reshape(t, t // length, r, m)
        out = np.einsum("kj,sbjm->sbkm", _butterfly(r), v) if r <= 5 else np.fft.fft(v, axis=2)
        buf = (out * tw32[(np.arange(r)[:, None] * np.arange(m)[None, :] * step) % t]).reshape(t, t)
        length //= r
    k = np.empty(t, dtype=np.int64)
    k[fft_positions(t)] = np.arange(t)
    a = (buf * np.exp(-2j * np.pi * np.outer(np.arange(t), k) / t).conj()).sum(axis=0) / t
    c = 1.0 / np.abs(a) ** 2
    c.flags.writeable = False
    return c


@functools.lru_cache(maxsize=16)
def device_tables(t: int, device: torch.device) -> torch.Tensor:
    """The kernel's table on `device`, float32 [4 t]: the twiddles as (re,
    im) pairs, the gain times round_trip_gain, the column. Built in
    float64, cast once per (t, device)."""
    twiddles, gain, column = fft_tables(t)
    gain = gain * round_trip_gain(t)
    flat = np.concatenate([np.stack([twiddles.real, twiddles.imag], axis=1).reshape(-1), gain, column])
    return torch.from_numpy(flat.astype(np.float32)).to(device)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_kuramoto_pair_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nsd_kuramoto_pair_sums.restype = ctypes.c_int
    lib.nsd_kuramoto_pair_sums_max_t.argtypes = []
    lib.nsd_kuramoto_pair_sums_max_t.restype = ctypes.c_int
    lib.nsd_kuramoto_pair_sums_refine_below.argtypes = []
    lib.nsd_kuramoto_pair_sums_refine_below.restype = ctypes.c_float
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def refine_below() -> float:
    """The kernel's near-zero threshold: a sample with |z|^2 below this
    share of its series' mean x^2 takes im as the reference's dense
    product (the library's constant; CUDA only)."""
    return float(_library().nsd_kuramoto_pair_sums_refine_below())


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32 windows, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != CHANNELS or x.shape[1] < 1:
        raise ValueError(f"expected windows [B, T, {CHANNELS}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("windows must be contiguous")


def kuramoto_pair_sums(x: torch.Tensor) -> torch.Tensor:
    """[B, T, 8] float32 windows -> [B, 8, 8] gram sums. Launches the CUDA
    kernel for a CUDA tensor (and counts the launch); takes the plain twin
    for a CPU tensor."""
    _check(x)
    if x.device.type == "cpu":
        return kuramoto_pair_sums_plain(x)
    b, t, c = x.shape
    out = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _library()
    max_t = lib.nsd_kuramoto_pair_sums_max_t()
    if t > max_t:
        raise ValueError(f"window length {t} exceeds the kernel's limit of {max_t}")
    tables = device_tables(t, x.device)
    plan = fft_plan(t)
    radices = (ctypes.c_int * max(len(plan), 1))(*plan)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nsd_kuramoto_pair_sums(
            x.data_ptr(), tables.data_ptr(), out.data_ptr(), b, t, radices, len(plan), stream
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out
