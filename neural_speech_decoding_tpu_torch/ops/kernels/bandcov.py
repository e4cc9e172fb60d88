"""Per-band spatial gram pairs: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
bandcov.py:35 (_gram_kernel, grid call _grams_batched:69, wrapper
band_grams:113). For whitened projection rows y [B, R, 8] float32 and band
row offsets o_0 < o_1 < ... < o_nb it returns, per window b, band k and
channel pair p = (c, d), c <= d in row-major order,

  out[b, k * 36 + p] = sum_{o_k <= r < o_(k+1)} y[b, r, c] * y[b, r, d]

unscaled (callers apply 2/T^2 and the shrinkage). The layout is the TPU's
[nb * 36, B] transposed, so that each window's pairs stay contiguous for
the feature kernel (ops/kernels/logmfeats.py). The kernel
(csrc/bandcov_grams.cu, plain nvcc, ctypes) runs for a CUDA tensor; the
plain twin for a CPU tensor, and as the kernel's test oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.kernels import build

NAME = "bandcov_grams"
CHANNELS = 8
PAIRS = CHANNELS * (CHANNELS + 1) // 2
MAX_BANDS = 16  # the kernel's Bands struct holds 17 offsets


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
    lib.nsd_band_grams_max_rows.argtypes = []
    lib.nsd_band_grams_max_rows.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(y: torch.Tensor, offsets: Sequence[int]) -> None:
    if not isinstance(y, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(y).__name__}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32 rows, got {y.dtype}")
    if y.dim() != 3 or y.shape[2] != CHANNELS:
        raise ValueError(f"expected rows [B, R, {CHANNELS}], got {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("rows must be contiguous")
    if y.device.type == "cuda" and y.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the kernel loads float4)")
    nb = len(offsets) - 1
    if not 1 <= nb <= MAX_BANDS:
        raise ValueError(f"expected 1 to {MAX_BANDS} bands, got {nb}")
    if offsets[0] < 0 or offsets[-1] > y.shape[1] or any(
        hi < lo for lo, hi in zip(offsets[:-1], offsets[1:])
    ):
        raise ValueError(f"band offsets {tuple(offsets)} do not fit {y.shape[1]} rows")


def band_grams(y: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """[B, R, 8] float32 rows, nb + 1 band offsets -> [B, nb * 36] pair
    sums. Launches the CUDA kernel for a CUDA tensor (and counts the
    launch); takes the plain twin for a CPU tensor."""
    offsets = tuple(int(o) for o in offsets)
    _check(y, offsets)
    if y.device.type == "cpu":
        return band_grams_plain(y, offsets)
    b, rows, _ = y.shape
    nb = len(offsets) - 1
    out = torch.empty((b, nb * PAIRS), dtype=torch.float32, device=y.device)
    if b == 0:
        return out
    lib = _library()
    if rows > lib.nsd_band_grams_max_rows():
        raise ValueError(f"{rows} rows exceed the kernel's limit of {lib.nsd_band_grams_max_rows()}")
    offs = (ctypes.c_int * (nb + 1))(*offsets)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.nsd_band_grams(y.data_ptr(), out.data_ptr(), b, rows, offs, nb, stream)
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out
