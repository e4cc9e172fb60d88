"""Fused Hilbert transform + Kuramoto pair sums: CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
kuramoto.py:60 (_pair_sums_kernel, wrapper kuramoto_pair_sums:120). For raw
windows x [B, T, C] float32 it returns the symmetric gram sums

  G[b, i, j] = sum_t (c2_i c2_j + s2_i s2_j)                 [B, C, C]

with im = H x (the dense Hilbert operator of ops/hilbert.py), c2 =
(x^2 - im^2) / p2, s2 = 2 x im / p2, p2 = x^2 + im^2, and c2 = 1, s2 = 0
where p2 < f32 tiny. The kernel (csrc/kuramoto_pair_sums.cu, built with
plain nvcc and bound with ctypes) runs for a CUDA tensor; the plain twin
for a CPU tensor, and as the kernel's test oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.hilbert import hilbert_matrix
from neural_speech_decoding_tpu_torch.ops.kernels import build

NAME = "kuramoto_pair_sums"
CHANNELS = 8  # the kernel is specialised to the 8-channel headset


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_kuramoto_pair_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nsd_kuramoto_pair_sums.restype = ctypes.c_int
    lib.nsd_kuramoto_pair_sums_max_t.argtypes = []
    lib.nsd_kuramoto_pair_sums_max_t.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=8)
def _hilbert_transposed(t: int, device: torch.device) -> torch.Tensor:
    """H^T on the card, so the kernel's reads of H[t, k] across threads
    t are coalesced (row k of H^T)."""
    return hilbert_matrix(t, device).t().contiguous()


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
    ht = _hilbert_transposed(t, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nsd_kuramoto_pair_sums(
            x.data_ptr(), ht.data_ptr(), out.data_ptr(), b, t, stream
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out
