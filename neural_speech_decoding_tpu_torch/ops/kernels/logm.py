"""Batched Chebyshev matrix log of SPD matrices: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
logm.py:39 (_clenshaw_kernel, grid call _clenshaw_batched:77-95, wrapper
logm_spd_chebyshev_pallas:139 / _logm_pallas_impl:149-181). For [..., 8, 8]
float32 SPD matrices S and the coefficients c_0..c_d of the Chebyshev
series of log on [lo, hi] it returns

  logm(S) ~= sum_k c_k T_k(t) + log(tr S / C) I,
  t = (2 A - (hi + lo) I) / (hi - lo),  A = S / (tr S / C).

The trace normalisation, the map onto the domain and the log(tr/C)
diagonal are plain PyTorch here, as the JAX wrapper leaves them to XLA;
the recurrence is the kernel's (csrc/logm_clenshaw.cu, plain nvcc, ctypes),
for a CUDA tensor. The plain twin, ops/spd.logm_chebyshev (the JAX
package's _logm_spd_chebyshev scan), runs for a CPU tensor and is the
kernel's test oracle on the card.

`logm_spd_chebyshev` is a torch.autograd.Function: its forward is the
kernel (the twin on the CPU) and its backward recomputes the log through
the plain Clenshaw scan under autograd, as the JAX wrapper's custom VJP
recomputes through its XLA scan (ops/pallas/logm.py:119-136).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from neural_speech_decoding_tpu_torch.ops import kernels, spd
from neural_speech_decoding_tpu_torch.ops.kernels import build

NAME = "logm_clenshaw"
CHANNELS = 8


@functools.lru_cache(maxsize=16)
def device_coeffs(coeffs: tuple, device: torch.device) -> torch.Tensor:
    """The coefficients as a float32 tensor on `device`, copied there once
    per coefficient set: the store the Chebyshev kernels read."""
    return torch.tensor(coeffs, dtype=torch.float64).to(device=device, dtype=torch.float32)


# The plain PyTorch version (the JAX scan): any float dtype; in float64 it
# is the kernel's accuracy reference.
logm_spd_chebyshev_plain = spd.logm_chebyshev


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_logm_clenshaw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nsd_logm_clenshaw.restype = ctypes.c_int
    lib.nsd_logm_clenshaw_max_degree.argtypes = []
    lib.nsd_logm_clenshaw_max_degree.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(s: torch.Tensor, coeffs: Sequence[float]) -> None:
    if not isinstance(s, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(s).__name__}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {s.device}")
    if s.dtype != torch.float32:
        raise TypeError(f"expected float32 matrices, got {s.dtype}")
    if s.dim() < 2 or s.shape[-2:] != (CHANNELS, CHANNELS):
        raise ValueError(f"expected [..., {CHANNELS}, {CHANNELS}] matrices, got {tuple(s.shape)}")
    if len(coeffs) < 1:
        raise ValueError("expected at least one Chebyshev coefficient")


def clenshaw(t: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """The recurrence alone: sum_k c_k T_k(t) of [M, 8, 8] float32
    symmetric matrices. Launches the kernel for a CUDA tensor (and counts
    the launch); takes ops/spd.clenshaw for a CPU tensor."""
    _check(t, coeffs)
    if t.dim() != 3:
        raise ValueError(f"expected [M, {CHANNELS}, {CHANNELS}] matrices, got {tuple(t.shape)}")
    if t.device.type == "cpu":
        return spd.clenshaw(t, coeffs)
    degree = len(coeffs) - 1
    lib = _library()
    if degree > lib.nsd_logm_clenshaw_max_degree():
        raise ValueError(f"degree {degree} exceeds the kernel's limit of {lib.nsd_logm_clenshaw_max_degree()}")
    t = t.contiguous()
    out = torch.empty_like(t)
    if t.shape[0] == 0:
        return out
    cbuf = device_coeffs(tuple(float(c) for c in coeffs), t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.nsd_logm_clenshaw(t.data_ptr(), out.data_ptr(), t.shape[0], cbuf.data_ptr(), degree, stream)
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out


def _logm_forward(s: torch.Tensor, coeffs: Sequence[float], lo: float, hi: float) -> torch.Tensor:
    if s.device.type == "cpu":
        return logm_spd_chebyshev_plain(s, coeffs, lo, hi)
    t, tr = spd.chebyshev_domain_map(s, lo, hi)
    out = clenshaw(t.reshape(-1, CHANNELS, CHANNELS), coeffs).reshape(s.shape)
    return out + torch.log(tr) * spd.eye_like(s)


class _LogmChebyshev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, coeffs, lo, hi):
        ctx.save_for_backward(s)
        ctx.args = (coeffs, lo, hi)
        return _logm_forward(s, coeffs, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        with torch.enable_grad():
            ss = s.detach().requires_grad_(True)
            (ds,) = torch.autograd.grad(logm_spd_chebyshev_plain(ss, *ctx.args), ss, grad)
        return ds, None, None, None


def logm_spd_chebyshev(s: torch.Tensor, coeffs: Sequence[float], lo: float, hi: float) -> torch.Tensor:
    """[..., 8, 8] float32 SPD matrices -> their Chebyshev matrix logs, the
    same shape. Launches the CUDA kernel for a CUDA tensor (and counts the
    launch); takes the plain twin for a CPU tensor. Differentiable in s:
    the backward recomputes through the twin."""
    _check(s, coeffs)
    return _LogmChebyshev.apply(s, tuple(float(c) for c in coeffs), float(lo), float(hi))
