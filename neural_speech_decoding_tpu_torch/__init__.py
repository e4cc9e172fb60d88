"""PyTorch + CUDA port of the imagined-speech EEG decoder, for NVIDIA Hopper.

Module names mirror `neural_speech_decoding_tpu` (the JAX package, which
stays the reference the port's tests hold it against). This package
imports torch, numpy and the standard library only.

  config.py      frozen dataclass configs (filter / decoder / pipeline)
  io/            .npz and .pth parameter loading, JAX-pytree conversion
  ops/           Hilbert operator, MAI (Kuramoto) filter, LSTM gate math,
                 kernels/ hand-written CUDA kernels with their plain twins
  models/        LSTM decoder (eval path)
  runtime/       boards, connector, streaming producer, InferenceEngine,
                 run_trials
  utils/         device selection, latency metrics

Entry points (`InferenceEngine`, `mai_filter_batch`, `run_trials`) run on
CUDA unless the caller passes `device="cpu"`; without CUDA they raise.
"""

__version__ = "0.1.0"

from neural_speech_decoding_tpu_torch.config import (  # noqa: F401
    FIVE_CLASS_NAMES,
    THREE_CLASS_NAMES,
    DecoderConfig,
    FilterConfig,
    PipelineConfig,
)
