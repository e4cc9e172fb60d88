"""Inference engine: batched decoding on one device.

Counterpart of neural_speech_decoding_tpu/runtime/engine.py:151-286 for
the LSTM families. One call of `predict_batch` runs the whole pipeline
on the engine's device:

  raw windows [B, T, C] -> ops/kuramoto.mai_filter_batch (fast mode: the
  pair-sums CUDA kernel on the card) -> models/lstm.decoder_logits ->
  softmax

Batch sizes are padded to powers of two (zero windows, sliced away), the
serving contract of the JAX engine. The engine runs on CUDA unless the
caller passes `device="cpu"`; without CUDA it raises.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import (
    FIVE_CLASS_NAMES,
    THREE_CLASS_NAMES,
    DecoderConfig,
    FilterConfig,
    PipelineConfig,
)
from neural_speech_decoding_tpu_torch.io.checkpoint import load_decoder_params
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

# family -> (classes, class names): the LSTM entries of the JAX registry
# (neural_speech_decoding_tpu/models/registry.py:167-168)
_FAMILIES = {
    "lstm": (3, THREE_CLASS_NAMES),
    "lstm5": (5, FIVE_CLASS_NAMES),
}


def _bucket(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n)))


def _disable_tf32() -> None:
    """Full-f32 matmuls and convolutions: the JAX package runs every
    matmul at Precision.HIGHEST, and TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not disable TF32")


class InferenceEngine:
    def __init__(
        self,
        model_path: Optional[str] = None,
        *,
        params=None,
        config: Optional[PipelineConfig] = None,
        class_names: Optional[Sequence[str]] = None,
        sample_rate: Optional[int] = None,
        model: str = "lstm",
        device: DeviceLike = None,
    ):
        """`model_path` is a native .npz pytree or a reference .pth;
        `params` a parameter pytree (numpy or tensor leaves) instead.
        `model` is "lstm" or "lstm5"; other families are not ported yet."""
        if model not in _FAMILIES:
            raise NotImplementedError(
                f"model family {model!r} is not ported yet; see ROADMAP.md"
            )
        self.device = resolve_device(device)
        _disable_tf32()
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params")
            if str(model_path).endswith(".npz"):
                params = load_params_npz(model_path)
            else:
                params = load_decoder_params(model_path)
        self.params = params_from_jax(params, self.device)

        num_classes, names = _FAMILIES[model]
        # Serving default: the fast filter (float32, the kernel route).
        config = config or PipelineConfig(
            class_names=names,
            decoder=DecoderConfig(num_classes=num_classes),
            filter=FilterConfig(precision="fast"),
        )
        if sample_rate is not None and sample_rate != config.sample_rate:
            # reference quirk: the predictor adopts the stream's reported
            # sample rate; the filter is rate-independent, so this only
            # changes the window geometry bookkeeping
            config = PipelineConfig(
                sample_rate=int(sample_rate),
                num_channels=config.num_channels,
                window_seconds=config.window_seconds,
                class_names=config.class_names,
                filter=config.filter,
                decoder=config.decoder,
            )
        self.config = config
        self.class_names = tuple(class_names or config.class_names)
        self._stats = {"windows": 0, "guard_flagged": 0}
        self._stats_lock = threading.Lock()

    @property
    def stats(self) -> Dict[str, int]:
        """{"windows", "guard_flagged"}; the LSTM has no domain guard, so
        guard_flagged stays 0."""
        with self._stats_lock:
            return dict(self._stats)

    @torch.no_grad()
    def _logits(self, windows_btc: torch.Tensor) -> torch.Tensor:
        filtered = mai_filter_batch(windows_btc, self.config.filter, device=self.device)
        return decoder_logits(self.params, filtered, self.config.decoder)

    def _decode(self, windows_btc, softmax: bool) -> np.ndarray:
        x = np.asarray(windows_btc, dtype=np.float32)
        if x.ndim != 3:
            raise ValueError(f"expected windows [B, T, C], got shape {x.shape}")
        b = x.shape[0]
        if b == 0:
            return np.zeros((0, len(self.class_names)), np.float32)
        bb = _bucket(b)
        if bb != b:  # zero windows, sliced away below
            x = np.concatenate([x, np.zeros((bb - b,) + x.shape[1:], np.float32)])
        out = self._logits(torch.from_numpy(x).to(self.device))
        if softmax:
            out = torch.softmax(out, dim=-1)
        out = out[:b].cpu().numpy()
        with self._stats_lock:
            self._stats["windows"] += b
        return out

    def logits_batch(self, windows_btc: np.ndarray) -> np.ndarray:
        """[B, T, C] -> logits [B, num_classes] (float32)."""
        return self._decode(windows_btc, softmax=False)

    def predict_batch(self, windows_btc: np.ndarray) -> np.ndarray:
        """[B, T, C] -> probabilities [B, num_classes] (float32)."""
        return self._decode(windows_btc, softmax=True)

    def predict(self, window_tc: np.ndarray) -> Tuple[np.ndarray, str]:
        """One [T, C] window -> (probs [classes] float32, label) — the
        reference SimplePredictor.predict contract."""
        probs = self.predict_batch(np.asarray(window_tc)[None])[0]
        return probs.astype(np.float32), self.class_names[int(np.argmax(probs))]

    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> None:
        """Run zero windows of each bucketed size once (builds the kernel
        library and the cuBLAS handles before the first real request)."""
        t, c = self.config.window_samples, self.config.num_channels
        for b in batch_sizes:
            x = torch.zeros((_bucket(b), t, c), dtype=torch.float32, device=self.device)
            self._logits(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
