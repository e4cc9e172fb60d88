"""Butterworth design for the port's IIR preprocessing.

Counterpart of the design half of neural_speech_decoding_tpu/ops/iir.py
(butter_sos, :33-52): scipy designs the second-order sections on the host,
once per argument set. The zero-phase cascade that runs them is
ops/kernels/iir.py. The per-stage sosfiltfilt family of the JAX module
(with odd padding and steady-state initial conditions) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import functools
from typing import Tuple


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
