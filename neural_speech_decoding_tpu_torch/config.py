"""Typed configuration for the decode pipeline.

Counterpart of neural_speech_decoding_tpu/config.py:14-140: the filter,
the pipeline (window geometry, `trials` per snapshot, the 3- and 5-class
names and filename prefixes, `five_class_pipeline`) and the LSTM's
decoder config, with every field of the JAX DecoderConfig. The other
families' configs live beside their models (models/eegnet.py, tcn.py,
transformer.py, lru.py, logcov.py) and equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Class index order is fixed by the shipped checkpoint head:
# 0=Food, 1=Water, 2=Background.
THREE_CLASS_NAMES: Tuple[str, ...] = ("Food", "Water", "BG-Noise")
FIVE_CLASS_NAMES: Tuple[str, ...] = ("Food", "Water", "BG-Noise", "Yes", "No")

# Trial CSV filename prefixes -> class index, per class set.
THREE_CLASS_PREFIXES: Tuple[str, ...] = ("food", "water", "backgroundnoise")
FIVE_CLASS_PREFIXES: Tuple[str, ...] = ("food", "water", "backgroundnoise", "yes", "no")


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Kuramoto-phase spatial filter ("MAI filter") configuration.

    `lambd` is the tailoring lambda of the production inference path;
    `renorm="diag"` with eps 1e-12 is the reference's renormalization,
    folded into lambda (ops/kuramoto._effective_lambda).
    """

    lambd: float = 1.25e-29
    renorm: str = "diag"  # "diag" | "none"
    eps: float = 1e-12
    # "highest": operator algebra in float64 with an LU solve.
    # "fast": float32 end to end with the unrolled Gauss-Jordan ridge.
    # mai_filter_batch takes the fused pair-sums route in fast mode (the
    # CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor).
    precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """LSTM decoder hyperparameters (JAX config.py:48-125).

    The shipped checkpoints fix the shapes (input 8, hidden 48, 2 layers,
    attention pooling + LayerNorm + Linear(48,32) -> RReLU -> Dropout ->
    Linear(32,classes)); the decoder reads them from the parameters and
    checks num_classes, and `init_decoder_params` builds them from these
    fields. Dropout acts in train mode only: between the LSTM layers (not
    after the last) and after the RReLU.
    """

    input_size: int = 8
    hidden_size: int = 48
    num_layers: int = 2
    num_classes: int = 3
    dropout: float = 0.60
    # torch nn.RReLU bounds; eval mode uses the mean slope (1/8 + 1/3) / 2,
    # train mode samples the slope from U(lower, upper) per element.
    rrelu_lower: float = 1.0 / 8.0
    rrelu_upper: float = 1.0 / 3.0
    layernorm_eps: float = 1e-5
    # dtype of the recurrence (recurrent matmul and gate math): "float32",
    # or "bfloat16", the turbo mode. The input projection, the attention
    # and the head stay float32.
    recurrence_dtype: str = "float32"
    # "rational": the ~1-ulp float32 tanh/sigmoid of ops/gates.py (other
    # dtypes take torch's builtins); "builtin": torch.tanh / torch.sigmoid.
    gate_math: str = "rational"
    # Eval mode, two layers, float32: with both on, the streaming step loop
    # (both layers and the attention pooling in one loop, no [T, B, H]
    # intermediates). Off, or in train mode, at another depth or in
    # bfloat16: the per-layer recurrence.
    fused_scan: bool = True
    streaming_scan: bool = True
    # lax.scan unroll factors of the JAX package (training and streaming
    # eval scans). They are XLA compile knobs: the port accepts them and
    # they change nothing in its eager loops.
    scan_unroll: int = 1
    eval_scan_unroll: int = 4
    # Train-time rematerialisation: split each layer's T steps into this
    # many chunks under torch.utils.checkpoint, so that backward keeps one
    # carry a chunk and recomputes the chunk's steps. 0 or 1 disables; it
    # must divide T. It changes no value and no gradient.
    remat_chunks: int = 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration (window geometry + stages)."""

    sample_rate: int = 125  # Hz, Neuropawn Knight board
    num_channels: int = 8
    window_seconds: float = 5.0
    trials: int = 10  # windows averaged per snapshot (the reference tester)
    class_names: Tuple[str, ...] = THREE_CLASS_NAMES
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    @property
    def window_samples(self) -> int:
        return max(1, int(self.window_seconds * self.sample_rate))


def five_class_pipeline() -> PipelineConfig:
    return PipelineConfig(
        class_names=FIVE_CLASS_NAMES,
        decoder=DecoderConfig(num_classes=5),
    )
