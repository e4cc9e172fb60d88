"""Per-band spatial gram pairs: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
bandcov.py:35 (_gram_kernel, grid call _grams_batched:69, wrapper
band_grams:113). For whitened projection rows y [B, R, 8] float32 and band
row offsets o_0 <= o_1 <= ... <= o_nb it returns, per window b, band k and
channel pair p = (c, d), c <= d in row-major order,

  out[b, k * 36 + p] = sum_{o_k <= r < o_(k+1)} y[b, r, c] * y[b, r, d]

unscaled (callers apply 2/T^2 and the shrinkage). The layout is the TPU's
[nb * 36, B] transposed, so that each window's pairs stay contiguous for
the feature kernel (ops/kernels/logmfeats.py).

The function is bound by bytes on an H100: the rows are read once and the
pairs written once (255 MB for B = 16384 logcov8 windows, 0.076 ms at
3.35 TB/s), against 0.53 GFLOP of products. The kernel
(csrc/bandcov_grams.cu, plain nvcc, ctypes) is therefore one streaming
read: a warp a (window, band), four rows a float64 tensor-core
instruction (mma m8n8k4 f64), each lane loading the one float that is both
its A and its B element, so every row is read once and coalesced. Products
of float32 values are exact in float64, so each pair is rounded once, to
within one float32 rounding of the exact gram. On an NVIDIA H100 80GB HBM3
at its 700 W power limit (chip_smoke.py) a call takes 0.089 ms at
B = 16384 (0.086 ms on the device, 89 % of the bound) and 0.016 ms at
B = 1024 (0.0054 ms on the device), against 0.1377 ms and 0.038-0.070 ms
for the first design (a block a window in shared memory, a thread a
pair); PERF.md (section 6) holds every run's times.

The launch path is lean, because at the served batch (B = 1024) the
kernel takes microseconds and the host's work per call would set the
time: each distinct (rows, offsets) is validated once, in a cache that
holds its ctypes array; autograd is entered only when a gradient is
wanted; the device context only when y is not on the current device. The
tensor itself (device, dtype, shape, contiguity, alignment) is checked on
every call, and the launch's error after every launch.

The kernel runs for a CUDA tensor; the plain twin for a CPU tensor, and as
the kernel's test oracle on the card. With a gradient wanted, `band_grams`
is a torch.autograd.Function whose forward is the kernel (the twin on the
CPU) and whose backward recomputes the pairs through the twin under
autograd, as the JAX wrapper's custom VJP recomputes through its XLA grams
(ops/pallas/bandcov.py:79-110).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.kernels import build

NAME = "bandcov_grams"
CHANNELS = 8
PAIRS = CHANNELS * (CHANNELS + 1) // 2
MAX_BANDS = 16  # the kernel's Bands struct holds 17 offsets
MAX_ROWS = 1 << 26  # the kernel's kMaxRows: its element offsets stay in int


def band_grams_plain(y: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version: per band y[:, band]^T @ y[:, band] (full
    float32 where TF32 is off), gathered to the upper triangle. Any float
    dtype: in float64 it is the kernel's accuracy reference."""
    iu, ju = torch.triu_indices(CHANNELS, CHANNELS, device=y.device)
    out = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        band = y[:, lo:hi]
        out.append(torch.matmul(band.transpose(1, 2), band)[:, iu, ju])
    return torch.cat(out, dim=1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_band_grams.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nsd_band_grams.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


class _Plan(NamedTuple):
    offsets: Tuple[int, ...]
    nb: int
    c_offsets: ctypes.Array  # the offsets as the kernel's int array


@functools.lru_cache(maxsize=64)
def _plan(rows: int, offsets: Tuple[int, ...]) -> _Plan:
    """The validated band layout of windows of `rows` rows. Cached, so a
    layout is checked once; a bad one raises on every call (lru_cache
    keeps no exception)."""
    offsets = tuple(int(o) for o in offsets)
    nb = len(offsets) - 1
    if not 1 <= nb <= MAX_BANDS:
        raise ValueError(f"expected 1 to {MAX_BANDS} bands, got {nb}")
    if offsets[0] < 0 or offsets[-1] > rows or any(hi < lo for lo, hi in zip(offsets[:-1], offsets[1:])):
        raise ValueError(f"band offsets {offsets} do not fit {rows} rows")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the kernel's limit of {MAX_ROWS}")
    return _Plan(offsets, nb, (ctypes.c_int * (nb + 1))(*offsets))


def _forward(y: torch.Tensor, plan: _Plan) -> torch.Tensor:
    if not y.is_cuda:
        return band_grams_plain(y, plan.offsets)
    b, rows, _ = y.shape
    out = torch.empty((b, plan.nb * PAIRS), dtype=torch.float32, device=y.device)
    if b == 0:
        return out
    lib = _library()
    index = y.device.index
    # the current stream's handle without building a torch.cuda.Stream (the
    # call PyTorch's own generated kernels launch with)
    stream = torch._C._cuda_getCurrentRawStream(index)
    on_device = contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index)
    with on_device:
        err = lib.nsd_band_grams(y.data_ptr(), out.data_ptr(), b, rows, plan.c_offsets, plan.nb, stream)
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out


class _BandGrams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, plan):
        ctx.save_for_backward(y)
        ctx.offsets = plan.offsets
        return _forward(y, plan)

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        with torch.enable_grad():
            yy = y.detach().requires_grad_(True)
            (dy,) = torch.autograd.grad(band_grams_plain(yy, ctx.offsets), yy, grad)
        return dy, None


def band_grams(y: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """[B, R, 8] float32 rows, nb + 1 band offsets -> [B, nb * 36] pair
    sums. Launches the CUDA kernel for a CUDA tensor (and counts the
    launch); takes the plain twin for a CPU tensor. Differentiable in y:
    the backward recomputes through the twin."""
    if not isinstance(y, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(y).__name__}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32 rows, got {y.dtype}")
    if y.dim() != 3 or y.shape[2] != CHANNELS:
        raise ValueError(f"expected rows [B, R, {CHANNELS}], got {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("rows must be contiguous")
    if y.is_cuda:
        if y.data_ptr() % 16:
            raise ValueError("rows must start on a 16-byte boundary")
    elif y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    plan = _plan(y.shape[1], offsets if type(offsets) is tuple else tuple(offsets))
    if torch.is_grad_enabled() and y.requires_grad:
        return _BandGrams.apply(y, plan)
    return _forward(y, plan)
