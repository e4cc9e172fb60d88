"""Typed configuration for the decode pipeline.

Counterpart of neural_speech_decoding_tpu/config.py:14-140: the filter,
the pipeline (window geometry, `trials` per snapshot, the 3- and 5-class
names, `five_class_pipeline`) and the LSTM's decoder config. Of the LSTM's
fields only those the port reads are kept: it runs the streaming
two-layer eval scan in float32, with its shapes taken from the parameters
(no bf16 turbo, no per-layer or training path, so no dropout, yet). The
other families' configs live beside their models (models/eegnet.py,
tcn.py, transformer.py, lru.py, logcov.py) and equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Class index order is fixed by the shipped checkpoint head:
# 0=Food, 1=Water, 2=Background.
THREE_CLASS_NAMES: Tuple[str, ...] = ("Food", "Water", "BG-Noise")
FIVE_CLASS_NAMES: Tuple[str, ...] = ("Food", "Water", "BG-Noise", "Yes", "No")


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
    """LSTM decoder hyperparameters of the eval path. The gates are always
    the rational tanh/sigmoid of ops/gates.py, as the JAX package evaluates
    them by default. The shipped
    checkpoints fix the shapes (input 8, hidden 48, 2 layers, attention
    pooling + LayerNorm + Linear(48,32) -> RReLU -> Linear(32,classes));
    the decoder reads them from the parameters and checks num_classes."""

    num_classes: int = 3
    # torch nn.RReLU bounds; eval mode uses the mean slope (1/8 + 1/3) / 2.
    rrelu_lower: float = 1.0 / 8.0
    rrelu_upper: float = 1.0 / 3.0
    layernorm_eps: float = 1e-5


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
