"""Transformer EEG encoder, eval path.

Counterpart of neural_speech_decoding_tpu/models/transformer.py:31-143:

  x [B, T, C] -> tokens: the first n·p samples, reshaped to [B, n, p·C]
  (time-major inside a patch) -> linear embed + the checkpoint's "pos"
  -> pre-LN blocks: LN -> q/k/v (wqkv split on its last axis, then heads)
     -> softmax(q kᵀ / sqrt(dh)) v -> wo, residual; LN -> tanh-GELU FFN,
     residual
  -> final LN -> mean over tokens -> linear head

The attention is written as matmul -> softmax -> matmul, as the JAX apply
computes it, not through scaled_dot_product_attention (whose fused
backends sum in another order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

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


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def transformer_apply(
    params: Params, x_btc: torch.Tensor, cfg: TransformerConfig = TransformerConfig()
) -> torch.Tensor:
    """[B, T, C] -> logits [B, num_classes], eval mode (no dropout)."""
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
        ctx = (att @ v).transpose(1, 2).reshape(b, n, d)
        tok = tok + ctx @ blk["wo"]

        y = _ln(tok, blk["ln2"], cfg.ln_eps)
        y = F.gelu(y @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"] + blk["b2"]
        tok = tok + y

    pooled = _ln(tok, params["ln_f"], cfg.ln_eps).mean(dim=1)
    return pooled @ params["head"]["w"] + params["head"]["b"]
