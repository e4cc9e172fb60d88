"""Data augmentation: the reference's noise injectors and EEG transforms
(host-side numpy; the port's own copy).

Counterpart of neural_speech_decoding_tpu/train/augment.py, draw for draw:
the same seed gives the same augmented copies in both packages.

KINDS are the reference's four fault injectors (burst, flatline, sine,
white noise). EEG_KINDS add the standard EEG training transforms:
  time_shift   roll along T (the capture window aligns loosely with the
               utterance onset);
  scale        per-channel amplitude scaling (electrode impedance varies
               per session);
  channel_drop zero one channel (a dry electrode losing contact).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

KINDS = ("burst", "flatline", "sine", "white")
EEG_KINDS = ("time_shift", "scale", "channel_drop")
ALL_KINDS = KINDS + EEG_KINDS


def inject_noise_np(
    window_tc: np.ndarray, kind: str, rng: np.random.Generator, strength: float = 1.0
) -> np.ndarray:
    """Apply one noise kind to a [T, C] window (a copy)."""
    t, c = window_tc.shape
    out = window_tc.copy()
    scale = float(np.std(window_tc)) or 1.0
    if kind == "white":
        out += strength * 0.5 * scale * rng.standard_normal((t, c)).astype(out.dtype)
    elif kind == "sine":
        freq = rng.uniform(5.0, 30.0)
        phase = rng.uniform(0, 2 * np.pi)
        tone = strength * scale * np.sin(2 * np.pi * freq * np.arange(t) / t + phase)
        ch = rng.integers(0, c)
        out[:, ch] += tone.astype(out.dtype)
    elif kind == "burst":
        start = rng.integers(0, max(1, t - t // 8))
        length = rng.integers(t // 16 + 1, t // 8 + 1)
        ch = rng.integers(0, c)
        out[start : start + length, ch] += (
            strength * 5 * scale * rng.standard_normal(min(length, t - start))
        ).astype(out.dtype)
    elif kind == "flatline":
        start = rng.integers(0, max(1, t - t // 8))
        length = rng.integers(t // 16 + 1, t // 8 + 1)
        ch = rng.integers(0, c)
        out[start : start + length, ch] = out[start, ch]
    elif kind == "time_shift":
        shift = int(rng.integers(-t // 10, t // 10 + 1))
        out = np.roll(out, shift, axis=0)
    elif kind == "scale":
        out *= rng.uniform(0.8, 1.2, size=(1, c)).astype(out.dtype)
    elif kind == "channel_drop":
        out[:, rng.integers(0, c)] = 0.0
    else:
        raise ValueError(f"unknown noise kind {kind!r}; options: {ALL_KINDS}")
    return out


def augment_batch_np(
    x_btc: np.ndarray,
    y: np.ndarray,
    prob: float = 0.5,
    seed: int = 0,
    strength: float = 1.0,
    kinds: Sequence[str] = KINDS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Augmented copies of a random subset of the batch (each window with
    probability `prob`, one kind each) and their labels."""
    rng = np.random.default_rng(seed)
    keep = rng.random(x_btc.shape[0]) < prob
    xs, ys = [], []
    for i in np.flatnonzero(keep):
        kind = kinds[rng.integers(0, len(kinds))]
        xs.append(inject_noise_np(x_btc[i], kind, rng, strength))
        ys.append(y[i])
    if not xs:
        return np.empty((0,) + x_btc.shape[1:], x_btc.dtype), np.empty((0,), y.dtype)
    return np.stack(xs), np.asarray(ys, dtype=y.dtype)
