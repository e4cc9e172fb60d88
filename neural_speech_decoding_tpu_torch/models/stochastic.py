"""Train-mode randomness of the decoders: dropout and the RReLU slope.

The JAX package draws these from jax.random keys; the port draws them from
one torch.Generator on the training device, which the caller passes down
(train/loop.py seeds it from TrainConfig.seed). The two frameworks give
different bits from the same seed, so the tests hold the port to JAX in
the deterministic limits (dropout 0, rrelu_lower == rrelu_upper) and
check the statistics of the draws apart.
"""

from __future__ import annotations

from typing import Optional

import torch


def require_generator(train: bool, generator: Optional[torch.Generator]) -> None:
    """JAX's `train=True requires rng`, for the port's generator."""
    if train and generator is None:
        raise ValueError("train=True requires a generator")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate), as jax.random.bernoulli and
    jnp.where do in the JAX package. Rate 0 keeps x as it is."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def uniform_like(x: torch.Tensor, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    """U(lo, hi) of x's shape, dtype and device (lo when lo == hi)."""
    return torch.empty_like(x).uniform_(lo, hi, generator=generator)
