"""Inference engine: batched decoding on one device.

Counterpart of neural_speech_decoding_tpu/runtime/engine.py:36-320. One
call of `predict_batch` runs the whole pipeline on the engine's device:

  raw windows [B, T, C] -> ops/kuramoto.mai_filter_batch (fast mode: the
  pair-sums CUDA kernel on the card) -> the family's decoder (the LSTM;
  EEGNet, the TCN, the transformer or the LRU through the spec's `apply`;
  or the log-covariance features and head, whose guard flags feed the
  stats) -> softmax

`_ServingBase` holds what InferenceEngine and EnsembleEngine share: the
thread-safe {"windows", "guard_flagged"} stats, with guard flags of
asynchronous calls parked on the device until `stats` is read,
power-of-two batch buckets (zero windows, sliced away, and never
counted), predict / predict_batch / predict_batch_async / logits_batch and
warmup. `InferenceEngine.decode_recording` frames a continuous recording
on the device and decodes it in chunks. The engines run on CUDA unless the
caller passes `device="cpu"`; without CUDA they raise.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FilterConfig, PipelineConfig
from neural_speech_decoding_tpu_torch.io.checkpoint import load_decoder_params
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.epoching import frame_signal, frame_times, num_frames
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def _bucket(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n)))


def _disable_tf32() -> None:
    """Full-f32 matmuls and convolutions: the JAX package runs every
    matmul at Precision.HIGHEST, and TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not disable TF32")


def _serving_config(spec, model: str) -> PipelineConfig:
    """The serving default: the fast filter (float32, the kernel route);
    LSTM families take their decoder config from the spec."""
    return PipelineConfig(
        class_names=spec.class_names,
        decoder=spec.config if model.startswith("lstm") else PipelineConfig().decoder,
        filter=FilterConfig(precision="fast"),
    )


class _ServingBase:
    """Shared serving surface. Subclasses set `device`, `config` and
    `class_names`, call `_init_serving()`, and implement `_forward`
    (windows tensor -> (logits, flags or None)); an ensemble also
    overrides `_probs`."""

    #: parked guard-flag vectors are folded (one host read each) when the
    #: list grows past this, so a caller that never reads `stats` cannot
    #: pin unbounded device memory
    _MAX_PARKED_FLAGS = 4096

    def _init_serving(self) -> None:
        self._stats = {"windows": 0, "guard_flagged": 0}
        self._parked: list = []  # (flags device tensor, windows) of async calls
        self._stats_lock = threading.Lock()

    @property
    def stats(self) -> Dict[str, int]:
        """{"windows", "guard_flagged"}: windows decoded, and those of them
        whose covariance spectrum the logcov guard clamped (always 0 for
        families without a guard). Padding windows are never counted.
        Folds the flags that `predict_batch_async` parked: the list is
        detached under the lock, read outside it, and added under it."""
        with self._stats_lock:
            pending, self._parked = self._parked, []
        if pending:
            folded = [(int(flags.sum().item()), b) for flags, b in pending]
            with self._stats_lock:
                for flagged, b in folded:
                    self._stats["guard_flagged"] += flagged
                    self._stats["windows"] += b
        with self._stats_lock:
            return dict(self._stats)

    def _park_flags(self, flags: torch.Tensor, b: int) -> None:
        """Park a guard-flag device tensor instead of reading it now (a host
        read would wait for the call); `stats` folds the parked ones."""
        with self._stats_lock:
            self._parked.append((flags, b))
            overflow = len(self._parked) > self._MAX_PARKED_FLAGS
        if overflow:
            _ = self.stats

    def _forward(self, windows_btc: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits, dim=-1)

    @torch.no_grad()
    def _decode(self, windows_btc, softmax: bool) -> np.ndarray:
        """Windows (host array, or a tensor on any device) -> probabilities
        or logits as a host array."""
        if isinstance(windows_btc, torch.Tensor):
            x = windows_btc.to(self.device, torch.float32)
        else:
            x = torch.from_numpy(np.ascontiguousarray(windows_btc, dtype=np.float32))
        if x.ndim != 3:
            raise ValueError(f"expected windows [B, T, C], got shape {tuple(x.shape)}")
        b = x.shape[0]
        if b == 0:
            return np.zeros((0, len(self.class_names)), np.float32)
        bb = _bucket(b)
        if bb != b:  # zero windows, sliced away below
            x = torch.cat([x, x.new_zeros((bb - b,) + tuple(x.shape[1:]))])
        logits, flags = self._forward(x.to(self.device).contiguous())
        out = self._probs(logits) if softmax else logits
        out = out[..., :b, :].cpu().numpy()
        flagged = 0 if flags is None else int(flags[:b].sum().item())
        with self._stats_lock:
            self._stats["windows"] += b
            self._stats["guard_flagged"] += flagged
        return out

    def logits_batch(self, windows_btc: np.ndarray) -> np.ndarray:
        """[B, T, C] -> logits (float32): [B, classes] for one model,
        [members, B, classes] for an ensemble."""
        return self._decode(windows_btc, softmax=False)

    def predict_batch(self, windows_btc: np.ndarray) -> np.ndarray:
        """[B, T, C] -> probabilities [B, classes] (float32)."""
        return self._decode(windows_btc, softmax=True)

    @torch.no_grad()
    def predict_batch_async(self, windows_btc) -> torch.Tensor:
        """[B, T, C] windows on the engine's device -> probabilities
        [B, classes] as a device tensor, without waiting for the card (no
        batch bucket, no host read). A family without a guard has its
        windows counted now; a guard's flags are parked on the device and
        folded into `stats`, with their windows, when it is next read."""
        x = torch.as_tensor(windows_btc, dtype=torch.float32, device=self.device)
        if x.ndim != 3:
            raise ValueError(f"expected windows [B, T, C], got shape {tuple(x.shape)}")
        logits, flags = self._forward(x.contiguous())
        b = int(x.shape[0])
        if flags is None:
            with self._stats_lock:
                self._stats["windows"] += b
        else:
            self._park_flags(flags, b)
        return self._probs(logits)

    def predict(self, window_tc: np.ndarray) -> Tuple[np.ndarray, str]:
        """One [T, C] window -> (probs [classes] float32, label) — the
        reference SimplePredictor.predict contract."""
        probs = self.predict_batch(np.asarray(window_tc)[None])[0]
        return probs.astype(np.float32), self.class_names[int(np.argmax(probs))]

    @torch.no_grad()
    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> None:
        """Run zero windows of each bucketed size once (builds the kernel
        libraries and the cuBLAS handles before the first real request);
        counts nothing."""
        t, c = self.config.window_samples, self.config.num_channels
        for b in batch_sizes:
            self._forward(torch.zeros((_bucket(b), t, c), dtype=torch.float32, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_params(path: str, model: str):
    """A native .npz pytree, or a reference .pth (LSTM families only)."""
    if str(path).endswith(".npz"):
        return load_params_npz(path)
    if not model.startswith("lstm"):
        raise ValueError(f".pth checkpoints are LSTM-family; got model={model!r}")
    return load_decoder_params(path)


class InferenceEngine(_ServingBase):
    def __init__(
        self,
        model_path: Optional[str] = None,
        *,
        params=None,
        config: Optional[PipelineConfig] = None,
        class_names: Optional[Sequence[str]] = None,
        sample_rate: Optional[int] = None,
        model: str = "lstm",
        turbo: bool = False,
        donate: bool = False,
        model_kw: Optional[dict] = None,
        mesh=None,
        device: DeviceLike = None,
    ):
        """`model_path` is a native .npz pytree or a reference .pth (LSTM
        families); `params` a parameter pytree (numpy or tensor leaves)
        instead. `model` is a family of models/registry.py; `model_kw`
        overrides its config (e.g. whiten=True for a whitened logcov
        checkpoint). `turbo`, `donate` and `mesh` are the JAX engine's
        keywords; only their defaults are served."""
        if turbo or donate or mesh is not None:
            raise NotImplementedError(
                "turbo, donate and mesh are not ported yet (ROADMAP.md: mesh/turbo serving)"
            )
        self._spec = get_model(model, **(model_kw or {}))
        self.device = resolve_device(device)
        _disable_tf32()
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params")
            params = load_params(model_path, model)
        self.params = params_from_jax(params, self.device)
        self._is_lstm = model.startswith("lstm")

        config = config or _serving_config(self._spec, model)
        if sample_rate is not None and sample_rate != config.sample_rate:
            # reference quirk: the predictor adopts the stream's reported
            # sample rate; the filter is rate-independent, so this only
            # changes the window geometry bookkeeping
            config = PipelineConfig(
                sample_rate=int(sample_rate),
                num_channels=config.num_channels,
                window_seconds=config.window_seconds,
                trials=config.trials,
                class_names=config.class_names,
                filter=config.filter,
                decoder=config.decoder,
            )
        self.config = config
        self.class_names = tuple(class_names or config.class_names)
        self._init_serving()

    def _forward(self, windows_btc: torch.Tensor):
        filtered = mai_filter_batch(windows_btc, self.config.filter, device=self.device)
        if self._is_lstm:
            # honours a custom DecoderConfig coming through PipelineConfig
            return decoder_logits(self.params, filtered, self.config.decoder), None
        if self._spec.apply_ex is None:
            return self._spec.apply(self.params, filtered), None
        logits, aux = self._spec.apply_ex(self.params, filtered)
        return logits, aux["domain_flags"]

    def decode_recording(self, signal_tc, hop_seconds: float = 1.0, max_batch: int = 4096):
        """Decode a continuous recording [T_total, C]: frame it into sliding
        windows (hop `int(hop_seconds * sample_rate)` samples) on the
        engine's device and decode them in chunks of `max_batch`. Returns
        (probs [N, classes] float32, window start seconds [N] float64)."""
        window = self.config.window_samples
        hop = max(1, int(hop_seconds * self.config.sample_rate))
        total = signal_tc.shape[0]
        n = num_frames(total, window, hop)
        if n <= 0:
            raise ValueError(
                f"recording of {total} samples is shorter than one {window}-sample window"
            )
        signal = torch.as_tensor(signal_tc, dtype=torch.float32, device=self.device)
        windows = frame_signal(signal, window, hop)
        chunks = [self.predict_batch(windows[i : i + max_batch]) for i in range(0, n, max_batch)]
        starts, _ = frame_times(total, window, hop, self.config.sample_rate)
        return np.concatenate(chunks, axis=0), starts.numpy()
