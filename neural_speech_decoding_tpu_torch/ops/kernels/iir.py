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
block_n and block_t have no meaning here and are not carried over; the
kernel's own launch shape (lanes a series, windows a block, shared memory
or not) comes from `launch_plan`, from the batch and the card's SM count
and shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

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


# The kernel's own limits (csrc/iir_cascade.cu: kMaxSections, kMaxSlots,
# kSlotCounts, kMaxLanes, kMaxThreads): S sections, G a power of two up to
# 16 (a group of lanes never straddles a warp), K slots a lane, the
# smallest of SLOT_COUNTS that holds ceil(S / G) sections.
MAX_SECTIONS = 32
MAX_SLOTS = 16
SLOT_COUNTS = (1, 2, 4, 7, 8, 14, 16)
MAX_LANES = 16
MAX_THREADS = 256
WARP = 32
STATIC_SMEM = 16  # the kernel's own shared memory: its mbarrier and sink word
# The two launch shapes. Staged: G = 2 lanes a series, whole windows in
# shared memory. In global memory: G = 1 (2 past 16 sections), 256 series
# a block. At T = 625, C = 8 and 14 sections on an H100 the staged shape
# is the faster at B = 1024 and 2048 (124 series an SM), the other at
# B = 3072 (186 an SM) and 16384 (chip_smoke.py phase 3c; PERF.md,
# section 6), hence the switch at 128 series an SM. A window over a
# block's shared memory always runs in global memory.
STAGED_LANES = 2
GLOBAL_MIN_SERIES_PER_SM = 128


class LaunchPlan(NamedTuple):
    """How the kernel is launched: `lanes` (G) threads a series,
    `block_series` series a block (`windows` whole windows of them when
    `staged` in `shared_bytes` of shared memory; 0 otherwise)."""

    lanes: int
    windows: int
    block_series: int
    blocks: int
    threads: int
    shared_bytes: int
    staged: bool


def slots(sections: int, lanes: int) -> int:
    """K, the slots a lane holds: the kernel's instantiation that runs
    `sections` sections over `lanes` lanes."""
    if lanes not in (1, 2, 4, 8, 16) or max(1, -(-sections // lanes)) > MAX_SLOTS:
        raise ValueError(f"lanes must be a power of two up to {MAX_LANES} that leaves at most {MAX_SLOTS} "
                         f"of the {sections} sections a lane, got {lanes}")
    return next(k for k in SLOT_COUNTS if k >= -(-sections // lanes))


def _shape(staged: bool, lanes: int, batch: int, t_len: int, channels: int, sections: int,
           smem_per_block: int) -> LaunchPlan:
    """The launch in one of the two shapes at G = `lanes`; staged: W the
    fewest whole windows that fill whole warps, within the block's limits."""
    slots(sections, lanes)
    window_bytes = 4 * t_len * channels
    if staged:
        if channels * lanes > MAX_THREADS or window_bytes + STATIC_SMEM > smem_per_block:
            raise ValueError(f"a window [{t_len}, {channels}] at {lanes} lanes a series does not fit one block")
        windows = WARP // math.gcd(WARP, channels * lanes)
        windows = max(1, min(windows, MAX_THREADS // (channels * lanes),
                             (smem_per_block - STATIC_SMEM) // window_bytes, batch))
        block_series, shared = windows * channels, windows * window_bytes
    else:
        windows, shared = 0, 0
        block_series = min(MAX_THREADS // lanes, batch * channels)
    threads = -(-block_series * lanes // WARP) * WARP
    blocks = -(-batch * channels // block_series)
    return LaunchPlan(lanes, windows, block_series, blocks, threads, shared, staged)


def launch_plan(batch: int, t_len: int, channels: int, sections: int, sms: int, smem_per_block: int) -> LaunchPlan:
    """The launch of `batch` windows [t_len, channels] through `sections`
    sections on a card of `sms` SMs and `smem_per_block` bytes of (opt-in)
    shared memory a block: staged while the card has fewer than
    GLOBAL_MIN_SERIES_PER_SM series an SM and a window fits a block, else
    in global memory."""
    if not 0 <= sections <= MAX_SECTIONS:
        raise ValueError(f"{sections} sections exceed the kernel's limit of {MAX_SECTIONS}")
    fits = channels * STAGED_LANES <= MAX_THREADS and 4 * t_len * channels + STATIC_SMEM <= smem_per_block
    if fits and batch * channels < GLOBAL_MIN_SERIES_PER_SM * sms:
        return _shape(True, STAGED_LANES, batch, t_len, channels, sections, smem_per_block)
    return _shape(False, 1 if sections <= MAX_SLOTS else 2, batch, t_len, channels, sections, smem_per_block)


def card_limits(device: torch.device) -> Tuple[int, int]:
    """(SMs, opt-in shared memory a block in bytes) of a CUDA card."""
    return _card_limits(torch.device(device).index or 0)


@functools.cache  # on every launch's host path; a card's limits never change
def _card_limits(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_iir_cascade.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nsd_iir_cascade.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, sos: np.ndarray, plan: LaunchPlan) -> torch.Tensor:
    """One launch of the kernel on contiguous CUDA windows x, with `plan`
    (counted)."""
    lib = _library()
    out = torch.empty_like(x)
    b, t, c = x.shape
    sbuf = np.ascontiguousarray(sos, dtype=np.float64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nsd_iir_cascade(
            x.data_ptr(), out.data_ptr(), b, t, c,
            sbuf.ctypes.data, sbuf.shape[0],
            plan.lanes, plan.block_series, int(plan.staged), stream,
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return out


def iir_cascade(x_btc: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """[B, T, C] float32 -> the stacked cascade forward then reversed,
    [B, T, C] float32. Launches the CUDA kernel for a CUDA tensor (and
    counts the launch), with `launch_plan`'s shape; takes the plain twin
    for a CPU tensor."""
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
    if sos.shape[0] > MAX_SECTIONS:
        raise ValueError(f"{sos.shape[0]} sections exceed the kernel's limit of {MAX_SECTIONS}")
    x = x_btc.contiguous()
    if x.numel() == 0:
        return torch.empty_like(x)
    b, t, c = x.shape
    return _launch(x, sos, launch_plan(b, t, c, sos.shape[0], *card_limits(x.device)))


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
