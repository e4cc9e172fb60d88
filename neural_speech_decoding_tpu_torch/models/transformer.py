"""Transformer EEG encoder.

Counterpart of neural_speech_decoding_tpu/models/transformer.py:31-143
(initialisation, train and eval mode):

  x [B, T, C] -> tokens: the first n·p samples, reshaped to [B, n, p·C]
  (time-major inside a patch) -> linear embed + the checkpoint's "pos"
  -> pre-LN blocks: LN -> q/k/v (wqkv split on its last axis, then heads)
     -> softmax(q kᵀ / sqrt(dh)) [dropout] v -> wo, residual;
     LN -> tanh-GELU FFN [dropout], residual
  -> final LN -> mean over tokens -> linear head

The attention is written as matmul -> softmax -> matmul, as the JAX apply
computes it, not through scaled_dot_product_attention (whose fused
backends sum in another order). The dropouts in brackets act in train
mode only, with masks drawn from the caller's generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neural_speech_decoding_tpu_torch.models.stochastic import dropout, require_generator

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    num_channels: int = 8
    num_classes: int = 3
    window_samples: int = 625
    patch: int = 25  # tokens = window_samples // patch
    embed: int = 64
    heads: int = 4
    layers: int = 2
    ffn: int = 128
    dropout: float = 0.3
    ln_eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return self.window_samples // self.patch


def _sinusoid(tokens: int, dim: int) -> np.ndarray:
    """The fixed sinusoidal positions of JAX :49-54."""
    pos = np.arange(tokens)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    return np.where(i % 2 == 0, np.sin(angle), np.cos(angle)).astype(np.float32)


def init_transformer_params(generator: torch.Generator, cfg: TransformerConfig) -> Params:
    """Glorot-normal weights (JAX :57-89), zero biases, LayerNorm scale 1,
    sinusoidal "pos"; float32 on the generator's device."""
    dev = generator.device

    def glorot(shape):
        return torch.randn(shape, generator=generator, device=dev) * math.sqrt(2.0 / (shape[0] + shape[-1]))

    def ln(d):
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    d, f = cfg.embed, cfg.ffn
    blocks = [
        {
            "ln1": ln(d),
            "wqkv": glorot((d, 3 * d)),
            "wo": glorot((d, d)),
            "ln2": ln(d),
            "w1": glorot((d, f)),
            "b1": torch.zeros(f, device=dev),
            "w2": glorot((f, d)),
            "b2": torch.zeros(d, device=dev),
        }
        for _ in range(cfg.layers)
    ]
    return {
        "embed": {"w": glorot((cfg.patch * cfg.num_channels, d)), "b": torch.zeros(d, device=dev)},
        "pos": torch.from_numpy(_sinusoid(cfg.tokens, d)).to(dev),
        "blocks": blocks,
        "ln_f": ln(d),
        "head": {"w": glorot((d, cfg.num_classes)), "b": torch.zeros(cfg.num_classes, device=dev)},
    }


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def transformer_apply(
    params: Params,
    x_btc: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B, T, C] -> logits [B, num_classes]; train mode drops out the
    attention weights and the FFN output with masks drawn from `generator`."""
    require_generator(train, generator)
    b, _, c = x_btc.shape
    n, p, d, h = cfg.tokens, cfg.patch, cfg.embed, cfg.heads
    dh = d // h

    x = x_btc.to(torch.float32)[:, : n * p, :].reshape(b, n, p * c)
    tok = x @ params["embed"]["w"] + params["embed"]["b"] + params["pos"]

    for blk in params["blocks"]:
        y = _ln(tok, blk["ln1"], cfg.ln_eps)
        q, k, v = torch.split(y @ blk["wqkv"], d, dim=-1)  # each [B, N, D]
        q = q.reshape(b, n, h, dh).transpose(1, 2)  # [B, H, N, dh]
        k = k.reshape(b, n, h, dh).transpose(1, 2)
        v = v.reshape(b, n, h, dh).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(float(dh)), dim=-1)
        if train:
            att = dropout(att, cfg.dropout, generator)
        ctx = (att @ v).transpose(1, 2).reshape(b, n, d)
        tok = tok + ctx @ blk["wo"]

        y = _ln(tok, blk["ln2"], cfg.ln_eps)
        y = F.gelu(y @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"] + blk["b2"]
        if train:
            y = dropout(y, cfg.dropout, generator)
        tok = tok + y

    pooled = _ln(tok, params["ln_f"], cfg.ln_eps).mean(dim=1)
    return pooled @ params["head"]["w"] + params["head"]["b"]
