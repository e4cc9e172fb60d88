"""Fused zero-phase IIR preprocessing: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
iir.py:38 (_cascade_kernel, grid call _cascade_pass:80-126, wrapper
fused_preprocess:133-171). `fused_preprocess` detrends each (window,
channel) series over T, runs the whole stacked cascade of second-order
sections forward and then time-reversed (the combined response
|H1 ... Hn|^2, not scipy's stage-by-stage sosfiltfilt: edge transients
differ slightly), and optionally z-scores each series. The detrend and the
z-score are plain PyTorch, as the JAX wrapper leaves them to XLA; the
cascade is the kernel's (csrc/iir_cascade.cu, plain nvcc, ctypes) for a
CUDA tensor, and the plain twin's, a PyTorch loop over T, for a CPU tensor
and as the kernel's test oracle on the card. The TPU tiling knobs
block_n and block_t have no meaning here and are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.iir import butter_sos
from neural_speech_decoding_tpu_torch.ops.kernels import build
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

NAME = "iir_cascade"


def collector_stages(fs: float = 125.0):
    """The production collector chain's sos stages (reference:
    Neural_decoding_data_collector.py:111-127): 4 + 2 + 4 + 4 = 14
    sections."""
    return [
        butter_sos("bandstop", 4, 39.5, 40.5, fs),
        butter_sos("bandpass", 2, 3.0, 48.0, fs),
        butter_sos("bandstop", 4, 49.5, 50.5, fs),
        butter_sos("bandstop", 4, 59.0, 61.0, fs),
    ]


def stack_sos(stages: Sequence) -> np.ndarray:
    """The stages' sections stacked into one [S, 6] float64 array."""
    sos = np.concatenate([np.asarray(s, dtype=np.float64).reshape(-1, 6) for s in stages], axis=0)
    return np.ascontiguousarray(sos)


def iir_cascade_plain(x_btc: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version: [B, T, C] through every section, forward then
    time-reversed, each from a zero state; the coefficients rounded to the
    input's dtype (float32 as the kernel's, float64 for the accuracy
    reference)."""
    rows = torch.from_numpy(np.asarray(sos, dtype=np.float64)).to(x_btc.dtype).tolist()
    y = x_btc
    for reverse in (False, True):
        zero = torch.zeros_like(y[:, 0])
        z0, z1 = [zero] * len(rows), [zero] * len(rows)
        out = torch.empty_like(y)
        for i in range(y.shape[1] - 1, -1, -1) if reverse else range(y.shape[1]):
            v = y[:, i]
            for s, (b0, b1, b2, _, a1, a2) in enumerate(rows):
                o = b0 * v + z0[s]
                z0[s] = b1 * v - a1 * o + z1[s]
                z1[s] = b2 * v - a2 * o
                v = o
            out[:, i] = v
        y = out
    return y


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_iir_cascade.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nsd_iir_cascade.restype = ctypes.c_int
    lib.nsd_iir_cascade_max_sections.argtypes = []
    lib.nsd_iir_cascade_max_sections.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def iir_cascade(x_btc: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """[B, T, C] float32 -> the stacked cascade forward then reversed,
    [B, T, C] float32. Launches the CUDA kernel for a CUDA tensor (and
    counts the launch); takes the plain twin for a CPU tensor."""
    if not isinstance(x_btc, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x_btc).__name__}")
    if x_btc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_btc.device}")
    if x_btc.dtype != torch.float32:
        raise TypeError(f"expected float32 windows, got {x_btc.dtype}")
    if x_btc.dim() != 3:
        raise ValueError(f"expected windows [B, T, C], got {tuple(x_btc.shape)}")
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [S, 6], got {sos.shape}")
    if x_btc.device.type == "cpu":
        return iir_cascade_plain(x_btc, sos)
    lib = _library()
    if sos.shape[0] > lib.nsd_iir_cascade_max_sections():
        raise ValueError(f"{sos.shape[0]} sections exceed the kernel's limit of {lib.nsd_iir_cascade_max_sections()}")
    x = x_btc.contiguous()
    out = torch.empty_like(x)
    b, t, c = x.shape
    if out.numel() == 0:
        return out
    sbuf = np.ascontiguousarray(sos)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nsd_iir_cascade(
            x.data_ptr(), out.data_ptr(), b, t, c,
            sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), sbuf.shape[0], stream,
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out


def fused_preprocess(
    x_btc,
    stages: Sequence,
    *,
    detrend: bool = True,
    zscore: bool = False,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Detrend + combined zero-phase cascade (+ optional per-series
    z-score) over windows [B, T, C] -> float32 [B, T, C] on `device` (CUDA
    unless the caller names another device). `stages`: a list of [S_i, 6]
    sos arrays (e.g. from ops/iir.butter_sos, or collector_stages())."""
    dev = resolve_device(device)
    x = torch.as_tensor(x_btc, device=dev).to(torch.float32)
    if detrend:
        x = x - x.mean(dim=1, keepdim=True)
    out = iir_cascade(x.contiguous(), stack_sos(stages))
    if zscore:
        mu = out.mean(dim=1, keepdim=True)
        sd = out.std(dim=1, keepdim=True, correction=0) + 1e-6
        out = (out - mu) / sd
    return out
