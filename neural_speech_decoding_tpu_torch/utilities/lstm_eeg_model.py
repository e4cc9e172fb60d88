"""`utilities.lstm_eeg_model`: the reference's `SimplePredictor`.

Keeps the reference constructor surface (lstm_eeg_model.py:49-84) over the
port's InferenceEngine; `predict` returns (probs float32 [classes], label)
as the reference does (lstm_eeg_model.py:86-101).

The filter runs at `FilterConfig(lambd=tailoring_lambda)`, whose precision
is "highest", as in `Utilities/lstm_eeg_model.py`: the float64 stages
filter on the engine's device, not the pair-sums kernel. `device=None`
means the current CUDA device (raising without CUDA); a device string is
passed to the engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from neural_speech_decoding_tpu_torch.config import (
    THREE_CLASS_NAMES,
    DecoderConfig,
    FilterConfig,
    PipelineConfig,
)
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike

CLASS_NAMES = list(THREE_CLASS_NAMES)


class SimplePredictor:
    def __init__(
        self,
        pth_path: str,
        sr: int,
        channel_order=None,
        input_size: int = 8,
        hidden_size: int = 48,
        num_layers: int = 2,
        num_classes: int = 3,
        dropout: float = 0.60,
        device: DeviceLike = None,
        tailoring_lambda: float = 1.25e-29,
        class_names: Optional[Sequence[str]] = None,
    ):
        config = PipelineConfig(
            sample_rate=int(sr),
            num_channels=input_size,
            class_names=tuple(class_names or CLASS_NAMES),
            filter=FilterConfig(lambd=tailoring_lambda),
            decoder=DecoderConfig(
                input_size=input_size,
                hidden_size=hidden_size,
                num_layers=num_layers,
                num_classes=num_classes,
                dropout=dropout,
            ),
        )
        self._engine = InferenceEngine(pth_path, config=config, class_names=config.class_names, device=device)

    def predict(self, chunk_TxC: np.ndarray):
        return self._engine.predict(np.asarray(chunk_TxC, dtype=np.float32))
