"""Analytic signal: the FFT form and the dense Hilbert operator.

Counterpart of neural_speech_decoding_tpu/ops/hilbert.py. scipy's
`hilbert(x)` zeroes the negative-frequency half of the spectrum and
doubles the positive half:

  n even: h[0] = h[n/2] = 1,  h[1:n/2] = 2,      h[n/2+1:] = 0
  n odd:  h[0] = 1,           h[1:(n+1)/2] = 2,  h[(n+1)/2:] = 0

For a real x the analytic signal is x + i * H x with a fixed [n, n]
operator H, so for a fixed window length the Hilbert step is one matmul.
H is built once in float64 from the FFT definition and cast to float32,
exactly as the JAX package builds it, so both packages use the same
numbers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _hilbert_gain(n: int) -> np.ndarray:
    h = np.zeros(n, dtype=np.float64)
    h[0] = 1.0
    if n % 2 == 0:
        h[1 : n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    return h


@functools.lru_cache(maxsize=8)
def _hilbert_transform_matrix(n: int) -> np.ndarray:
    """Dense Hilbert operator H [n, n] (float64) with H @ x = imag(hilbert(x))."""
    h = _hilbert_gain(n)
    a = np.fft.ifft(h[:, None] * np.fft.fft(np.eye(n), axis=0), axis=0)
    return np.ascontiguousarray(a.imag)


@functools.lru_cache(maxsize=16)
def hilbert_matrix(n: int, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """H [n, n] as a tensor on `device` (cached; callers must not modify it)."""
    h = torch.from_numpy(_hilbert_transform_matrix(n)).to(dtype)
    return h.to(device)


def analytic_signal(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Complex analytic signal of real `x` along `dim` (scipy semantics)."""
    n = x.shape[dim]
    spec = torch.fft.fft(x, dim=dim)
    gain = torch.from_numpy(_hilbert_gain(n)).to(device=x.device, dtype=x.dtype)
    shape = [1] * x.dim()
    shape[dim] = n
    return torch.fft.ifft(spec * gain.reshape(shape), dim=dim)


def instantaneous_phase(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """angle(hilbert(x)) along `dim`, the Kuramoto phase input (JAX
    ops/hilbert.py:47-50), in x's dtype on x's device."""
    z = analytic_signal(x, dim=dim)
    return torch.atan2(z.imag, z.real)


def analytic_signal_matmul(x_tc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) of the analytic signal over the time axis of [..., T, C]
    via the dense Hilbert operator, in x's dtype."""
    t = x_tc.shape[-2]
    h = hilbert_matrix(t, x_tc.device, x_tc.dtype)
    return x_tc, torch.matmul(h, x_tc)
