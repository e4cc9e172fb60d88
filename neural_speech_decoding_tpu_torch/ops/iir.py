"""IIR filtering: Butterworth design and zero-phase biquad cascades.

Counterpart of neural_speech_decoding_tpu/ops/iir.py. scipy designs the
second-order sections on the host, once per argument set (`butter_sos`).
The cascades run along axis 0 of a time-major [T, C] tensor, on the
tensor's device and in its dtype:

  * `sosfilt` / `sosfiltfilt`: the sequential biquad recursion (direct
    form II transposed, scipy.signal.sosfilt semantics), one step a sample;
  * `sosfilt_parallel` / `sosfiltfilt_parallel`: the same cascade as a
    log-depth scan. Each biquad is an affine map of its 2-vector state,
    and affine maps compose associatively, so a doubling (Hillis-Steele)
    scan over T runs ceil(log2 T) batched steps instead of T;
  * `collector_filter_chain(_batch)`: the reference's collection-time
    chain (constant detrend, 40/50/60 Hz bandstops, 3-48 Hz bandpass,
    each zero-phase), by those two routes or as one dense [T, T] operator
    built in float64 through scipy (`matmul`, the default for batches).

padtype="odd" reproduces scipy.signal.sosfiltfilt's odd extension with
steady-state initial conditions; padtype=None is the pad-free
forward-backward pass (BrainFlow's behaviour, which produced the shipped
dataset). The fused 14-section cascade kernel of the served
preprocessing is ops/kernels/iir.py; the collector chain does not use it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.utils.device import disable_tf32


@functools.lru_cache(maxsize=64)
def butter_sos(kind: str, order: int, lo: float, hi: float, fs: float) -> Tuple[Tuple[float, ...], ...]:
    """Butterworth second-order sections; kind: bandpass, bandstop,
    lowpass or highpass. scipy semantics: band filters have order 2*order.
    Returned as a hashable tuple of [S, 6] rows (b0, b1, b2, a0, a1, a2)."""
    from scipy.signal import butter

    if kind in ("bandpass", "bandstop"):
        wn = (lo, hi)
    elif kind == "lowpass":
        wn = hi
    elif kind == "highpass":
        wn = lo
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    sos = butter(order, wn, btype=kind, fs=fs, output="sos")
    return tuple(tuple(float(v) for v in row) for row in sos)


def _sos_array(sos) -> np.ndarray:
    arr = np.asarray(sos, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError(f"sos must be [S, 6], got {arr.shape}")
    return arr


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state (unit-step) initial biquad states, like
    scipy.signal.sosfilt_zi: [S, 2], each section's state scaled by the
    cumulative DC gain of the sections before it."""
    sos = _sos_array(sos)
    zi = np.zeros((sos.shape[0], 2))
    scale = 1.0
    for s, (b0, b1, b2, _a0, a1, a2) in enumerate(sos):
        g = (b0 + b1 + b2) / (1.0 + a1 + a2)  # section DC gain
        z2 = b2 - a2 * g
        z1 = (b1 - a1 * g) + z2
        zi[s] = (scale * z1, scale * z2)
        scale *= g
    return zi


def sosfilt(sos, x_tc: torch.Tensor, zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal biquad cascade along axis 0 of [T, C], one step a sample.
    `zi`: optional initial states [S, 2, C]."""
    sos = _sos_array(sos)
    n_sections = sos.shape[0]
    if zi is None:
        z = [[x_tc.new_zeros(x_tc.shape[1:]) for _ in range(2)] for _ in range(n_sections)]
    else:
        zi = zi.to(x_tc.dtype)
        z = [[zi[s, 0], zi[s, 1]] for s in range(n_sections)]
    coeffs = sos.tolist()  # python floats: scalars cast to the tensor's dtype
    out = torch.empty_like(x_tc)
    for t in range(x_tc.shape[0]):
        y = x_tc[t]
        for s, (b0, b1, b2, _a0, a1, a2) in enumerate(coeffs):
            z1, z2 = z[s]
            o = b0 * y + z1
            z[s] = [b1 * y - a1 * o + z2, b2 * y - a2 * o]
            y = o
        out[t] = y
    return out


def _powers(a_mat: np.ndarray, t_len: int) -> np.ndarray:
    """A^1 .. A^t_len of a 2x2 matrix, in float64: [t_len, 2, 2]."""
    out = np.empty((t_len, 2, 2))
    out[0] = a_mat
    for k in range(1, t_len):
        out[k] = a_mat @ out[k - 1]
    return out


def sosfilt_parallel(sos, x_tc: torch.Tensor, zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The biquad cascade as log-depth scans. A DF2T biquad is affine in
    its state z:

        z_{t+1} = A z_t + B x_t,   y_t = b0 x_t + z_t[0]
        A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0, b2 - a2 b0]

    so z_{t+1} = A^(t+1) z_0 + c_t with c_t = sum_{s<=t} A^(t-s) B x_s. A
    doubling scan builds c: after the step of offset d each c_t sums its
    last min(t+1, 2d) terms, by c_t += A^d c_(t-d). A is the same at every
    t, so each step applies one power A^d, and the powers come from a
    float64 table on the host: the scan rounds only the sums.

    x_tc: [T, C]; `zi`: optional initial states [S, 2, C]. Returns [T, C]."""
    sos = _sos_array(sos)
    t_len = x_tc.shape[0]
    y = x_tc
    for s, (b0, b1, b2, _a0, a1, a2) in enumerate(sos.tolist()):
        powers = _powers(np.array([[-a1, 1.0], [-a2, 0.0]]), t_len)
        b_vec = torch.tensor([b1 - a1 * b0, b2 - a2 * b0], dtype=y.dtype, device=y.device)
        c = y[:, :, None] * b_vec  # [T, C, 2]
        d = 1
        while d < t_len:
            a_d = torch.as_tensor(powers[d - 1], dtype=y.dtype, device=y.device)
            c = torch.cat([c[:d], c[d:] + torch.einsum("ij,tcj->tci", a_d, c[:-d])])
            d *= 2
        if zi is not None:
            z_init = zi[s].T.to(y.dtype)  # [C, 2]
            a_cum = torch.as_tensor(powers, dtype=y.dtype, device=y.device)
            c = c + torch.einsum("tij,cj->tci", a_cum, z_init)
            z1_first = z_init[None, :, 0]
        else:
            z1_first = torch.zeros_like(c[:1, :, 0])
        z1 = torch.cat([z1_first, c[:-1, :, 0]])
        y = b0 * y + z1
    return y


def _odd_ext(x_tc: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by n samples at both ends of axis 0."""
    left = 2 * x_tc[0] - x_tc[1 : n + 1].flip(0)
    right = 2 * x_tc[-1] - x_tc[-(n + 1) : -1].flip(0)
    return torch.cat([left, x_tc, right])


def default_padlen(sos) -> int:
    """scipy.signal.sosfiltfilt's default padlen: 3 * (2*S + 1 - min(#
    sections with b2 == 0, # sections with a2 == 0))."""
    sos = _sos_array(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return 3 * int(ntaps)


def _zero_phase(filt, sos, x_tc: torch.Tensor, padtype: Optional[str], padlen: Optional[int]) -> torch.Tensor:
    if padtype is None:
        y = filt(sos, x_tc)
        return filt(sos, y.flip(0)).flip(0)
    if padtype != "odd":
        raise ValueError("padtype must be 'odd' or None")
    n = default_padlen(sos) if padlen is None else int(padlen)
    if n >= x_tc.shape[0]:
        raise ValueError(f"padlen {n} >= signal length {x_tc.shape[0]}")
    ext = _odd_ext(x_tc, n)
    # scipy scales the steady-state initial conditions by the edge samples
    zi = torch.as_tensor(sosfilt_zi(sos), dtype=ext.dtype, device=ext.device)[:, :, None]
    y = filt(sos, ext, zi=zi * ext[0])
    y = y.flip(0)
    y = filt(sos, y, zi=zi * y[0]).flip(0)
    return y[n : n + x_tc.shape[0]]


def sosfiltfilt(sos, x_tc: torch.Tensor, padtype: Optional[str] = "odd", padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filtering by the sequential cascade: forward pass, then
    the reversed pass."""
    return _zero_phase(sosfilt, sos, x_tc, padtype, padlen)


def sosfiltfilt_parallel(
    sos, x_tc: torch.Tensor, padtype: Optional[str] = "odd", padlen: Optional[int] = None
) -> torch.Tensor:
    """Zero-phase filtering by the log-depth cascade (the initial
    conditions fold into the scan's first state)."""
    return _zero_phase(sosfilt_parallel, sos, x_tc, padtype, padlen)


def detrend_constant(x_tc: torch.Tensor) -> torch.Tensor:
    """Remove the per-channel mean (BrainFlow DetrendOperations.CONSTANT)."""
    return x_tc - x_tc.mean(dim=0, keepdim=True)


# ---------------------------------------------------------------------------
# The collector chain
# ---------------------------------------------------------------------------
_COLLECTOR_STAGES = (
    ("bandstop", 4, 39.5, 40.5),
    ("bandpass", 2, 3.0, 48.0),
    ("bandstop", 4, 49.5, 50.5),
    ("bandstop", 4, 59.0, 61.0),
)


def _chain_dtype(x: torch.Tensor) -> torch.dtype:
    # float64 stays float64; everything else runs in float32
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def collector_filter_chain(
    x_tc: torch.Tensor,
    fs: float = 125.0,
    padtype: Optional[str] = None,
    method: str = "scan",
) -> torch.Tensor:
    """The reference's collection-time preprocessing of one [T, C] window
    (or of [T, N] columns): constant detrend, then each zero-phase stage.
    method: "scan" (sequential) or "parallel" (log-depth)."""
    filt = sosfiltfilt if method == "scan" else sosfiltfilt_parallel
    y = detrend_constant(x_tc.to(_chain_dtype(x_tc)))
    for kind, order, lo, hi in _COLLECTOR_STAGES:
        y = filt(butter_sos(kind, order, lo, hi, float(fs)), y, padtype=padtype)
    return y


@functools.lru_cache(maxsize=16)
def _chain_operator(t: int, fs: float, padtype: Optional[str]) -> np.ndarray:
    """The whole collector chain as one dense [T, T] float64 operator.

    Every step (detrend, odd extension, each zero-phase stage, truncation)
    is linear, so for a fixed window length the chain is one matrix, built
    by pushing the identity through the scipy reference."""
    import scipy.signal

    m = np.eye(t) - np.full((t, t), 1.0 / t)  # constant detrend
    for kind, order, lo, hi in _COLLECTOR_STAGES:
        sos = np.asarray(butter_sos(kind, order, lo, hi, float(fs)))
        if padtype is None:
            fwd = scipy.signal.sosfilt(sos, m, axis=0)
            m = scipy.signal.sosfilt(sos, fwd[::-1], axis=0)[::-1]
        else:
            m = scipy.signal.sosfiltfilt(sos, m, axis=0, padtype=padtype)
    return np.ascontiguousarray(m)


@functools.lru_cache(maxsize=16)
def _operator_on(t: int, fs: float, padtype: Optional[str], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_chain_operator(t, fs, padtype), dtype=dtype, device=device)


def collector_filter_chain_batch(
    x_btc,
    fs: float = 125.0,
    padtype: Optional[str] = None,
    method: str = "matmul",
) -> torch.Tensor:
    """Batched collector chain [B, T, C] -> [B, T, C], on the input's
    device (a host array runs on the CPU) in its dtype (float64 stays
    float64, anything else runs in float32).

    method:
      "matmul"   one [T, T] operator product (TF32 off on the card)
      "parallel" log-depth cascades
      "scan"     sequential biquads
    """
    x = torch.as_tensor(x_btc)
    x = x.to(_chain_dtype(x))
    b, t, c = x.shape
    if method == "matmul":
        if x.device.type == "cuda":
            disable_tf32()
        op = _operator_on(t, float(fs), padtype, x.dtype, x.device)
        return torch.einsum("ts,bsc->btc", op, x)
    if method not in ("parallel", "scan"):
        raise ValueError(f"unknown method {method!r}")
    # channels are independent: filter all B*C series as columns at once
    x_tn = x.permute(1, 0, 2).reshape(t, b * c)
    y = collector_filter_chain(x_tn, fs, padtype, method=method)
    return y.reshape(t, b, c).permute(1, 0, 2).contiguous()
