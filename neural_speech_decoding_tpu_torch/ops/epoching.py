"""Epoching: frame a continuous recording into fixed windows.

Counterpart of neural_speech_decoding_tpu/ops/epoching.py:17-48. The
windows are a strided view of the recording on its own device (no copy):
`decode_recording` moves the recording to the card once and decodes the
view in chunks.
"""

from __future__ import annotations

from typing import Tuple

import torch


def num_frames(total: int, window: int, hop: int) -> int:
    if total < window:
        return 0
    return (total - window) // hop + 1


def frame_signal(signal_tc: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """[T_total, C] -> [N, window, C] with N = (T_total - window) // hop + 1,
    a view of `signal_tc`."""
    total = signal_tc.shape[0]
    if num_frames(total, window, hop) <= 0:
        raise ValueError(f"signal length {total} shorter than window {window}")
    return signal_tc.unfold(0, window, hop).transpose(1, 2)


def frame_times(total: int, window: int, hop: int, sample_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start_seconds, end_seconds) of each frame, float64 on the CPU."""
    n = num_frames(total, window, hop)
    starts = torch.arange(n, dtype=torch.float64) * hop / sample_rate
    return starts, starts + window / sample_rate
