"""PyTorch + CUDA port of the imagined-speech EEG decoder, for NVIDIA Hopper.

Module names mirror `neural_speech_decoding_tpu` (the JAX package, which
stays the reference the port's tests hold it against). This package
imports torch, numpy and the standard library only (and scipy, inside
ops/iir.butter_sos, for the Butterworth design).

  config.py      frozen dataclass configs (filter / decoder / pipeline)
  io/            .npz and .pth parameter loading, JAX-pytree conversion
  ops/           epoching, Hilbert operator, MAI (Kuramoto) filter, LSTM gate math,
                 8x8 SPD algebra (spd.py), Butterworth design (iir.py),
                 kernels/ hand-written CUDA kernels with their plain twins
                 (pair sums, band grams, logcov features, Clenshaw matrix
                 log, zero-phase IIR cascade)
  models/        every decoder family of the JAX registry in eval mode
                 (LSTM, log-covariance, EEGNet, TCN, transformer, LRU),
                 the registry of families
  runtime/       boards, connector, streaming producer, InferenceEngine,
                 EnsembleEngine, run_trials and the tester CLI
  utils/         device selection, latency metrics

Entry points (`InferenceEngine`, `EnsembleEngine`, `mai_filter_batch`,
`fused_preprocess`, `run_trials`) run on CUDA unless the caller passes `device="cpu"`;
without CUDA they raise.
"""

__version__ = "0.1.0"

from neural_speech_decoding_tpu_torch.config import (  # noqa: F401
    FIVE_CLASS_NAMES,
    THREE_CLASS_NAMES,
    DecoderConfig,
    FilterConfig,
    PipelineConfig,
)
