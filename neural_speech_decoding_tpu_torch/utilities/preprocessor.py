"""`utilities.preprocessor`: the reference's `PreProcessor`.

Keeps the reference's surface (preprocessor.py:15-36): [T, C] in,
Kuramoto-filtered float32 [T, C] out, with the tailoring lambda. The
filter is ops/kuramoto.mai_filter at `FilterConfig(lambd=tailoring_lambda)`
("highest": float64 stages) on `device`, the current CUDA device unless
the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


class PreProcessor:
    def __init__(self, sr: int, tailoring_lambda: float = 1.25e-29, device: DeviceLike = None):
        self.sr = sr
        self.tailoring_lambda = tailoring_lambda
        self.device = resolve_device(device)
        self._config = FilterConfig(lambd=tailoring_lambda)

    def transform(self, chunk_samples_by_channels: np.ndarray) -> np.ndarray:
        x = np.asarray(chunk_samples_by_channels)
        if x.ndim != 2:
            raise ValueError(
                f"Expected 2D array [samples, channels], got {x.shape}"
            )
        w = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
        return mai_filter(w, self._config).cpu().numpy()
