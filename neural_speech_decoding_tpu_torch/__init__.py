"""PyTorch + CUDA port of the imagined-speech EEG decoder, for NVIDIA Hopper.

Module names mirror `neural_speech_decoding_tpu` (the JAX package, which
stays the reference the port's tests hold it against). This package
imports torch, numpy and the standard library only (and scipy, for the
Butterworth design and the collector chain's operator in ops/iir.py).

  config.py      frozen dataclass configs (filter / decoder / pipeline)
  io/            .npz and .pth parameter loading and writing, JAX-pytree
                 conversion, the trial CSV dataset
  ops/           epoching, Hilbert operator, MAI (Kuramoto) filter, LSTM gate math,
                 8x8 SPD algebra (spd.py), Butterworth design, zero-phase
                 biquad cascades and the collector chain (iir.py),
                 kernels/ hand-written CUDA kernels with their plain twins
                 (pair sums, band grams, logcov features, Clenshaw matrix
                 log, zero-phase IIR cascade)
  models/        every decoder family of the JAX registry, with its init
                 and train mode (LSTM, log-covariance, EEGNet, TCN,
                 transformer, LRU), the registry of families
  runtime/       boards (synthetic, replay, native C++ through ctypes,
                 serial, BrainFlow), connector, streaming producer,
                 InferenceEngine, EnsembleEngine, run_trials and the tester
                 CLI, StreamDecoder and the stream CLI
  collector/     the recording chain, the headless experiment and its CLI,
                 stimulus presenters (terminal, browser), .psyexp parsing
  frontend/      the stdlib web dashboard and the Streamlit page
  train/         the training loop, augmentation, checkpoint/resume, and
                 the CLI (python -m neural_speech_decoding_tpu_torch.train)
  analysis/      signal-file intake (CSV, EDF), filter metrics, and the
                 offline and real-time filter-analysis CLIs
  tools/         cross-validation, session-level accuracy, deployment
                 ensemble fitting, the streaming soak, the model-selection
                 sweep, held-out accuracy of the shipped checkpoints, the
                 per-precision fidelity report
  parallel/      data parallelism on a one-process device mesh
  utilities/     the reference app's import surface (the counterpart of
                 the repository's Utilities/: tester, SimplePredictor,
                 PreProcessor, the connector, board and producer classes)
  utils/         device selection, latency metrics, profiler tracing
  quickstart.py  every surface in one run
  entry.py       entry(), a forward step, and dryrun_multichip(n)

Entry points (`InferenceEngine`, `EnsembleEngine`, `mai_filter_batch`,
`fused_preprocess`, `run_trials`, `train`, the stream, collector and
dashboard CLIs, `record_trial`, `run_experiment`, the analysis CLIs and
`KuramotoSpatialFilter`, the tools, `device_trace`, `utilities/`, the
quickstart, `entry()` and `dryrun_multichip`) run on CUDA unless the
caller passes `device="cpu"`; without CUDA they raise.
"""

__version__ = "0.1.0"

from neural_speech_decoding_tpu_torch.config import (  # noqa: F401
    FIVE_CLASS_NAMES,
    THREE_CLASS_NAMES,
    DecoderConfig,
    FilterConfig,
    PipelineConfig,
)
