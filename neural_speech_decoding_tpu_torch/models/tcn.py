"""Temporal convolutional network (residual stack), eval path.

Counterpart of neural_speech_decoding_tpu/models/tcn.py:27-124:

  x [B, T, C] -> [B, C, T]; res = proj-einsum of x (C -> width)
  -> per block i (dilation 2^i): causal conv -> GELU -> causal conv
     -> LayerNorm over channels -> GELU(y + res), which is the next res
  -> mean over time -> linear head

The causal convolutions pad (k - 1) 2^i samples on the left only. GELU is
the tanh approximation, as jax.nn.gelu computes it by default; the
LayerNorm takes the population variance. The number of blocks is that of
params["blocks"], as in the JAX apply.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TCNConfig:
    num_channels: int = 8
    num_classes: int = 3
    width: int = 48
    kernel: int = 7
    # dilations double per block: receptive field = 1 + (k-1) * sum(dilations)
    blocks: int = 5
    dropout: float = 0.3
    ln_eps: float = 1e-5


def _causal_conv(x_bct: torch.Tensor, w_oik: torch.Tensor, dilation: int) -> torch.Tensor:
    pad = (w_oik.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x_bct, (pad, 0)), w_oik, dilation=dilation)


def _ln_channels(x_bct: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mean = x_bct.mean(dim=1, keepdim=True)
    var = torch.square(x_bct - mean).mean(dim=1, keepdim=True)
    y = (x_bct - mean) / torch.sqrt(var + eps)
    return y * p["scale"][None, :, None] + p["bias"][None, :, None]


def tcn_apply(params: Params, x_btc: torch.Tensor, cfg: TCNConfig = TCNConfig()) -> torch.Tensor:
    """[B, T, C] -> logits [B, num_classes], eval mode (no dropout)."""
    x = x_btc.to(torch.float32).transpose(1, 2)  # [B, C, T]
    res = torch.einsum("bct,cw->bwt", x, params["proj"])
    h = x
    for i, blk in enumerate(params["blocks"]):
        dilation = 2**i
        y = _causal_conv(h, blk["w1"], dilation) + blk["b1"][None, :, None]
        y = F.gelu(y, approximate="tanh")
        y = _causal_conv(y, blk["w2"], dilation) + blk["b2"][None, :, None]
        y = _ln_channels(y, blk["ln"], cfg.ln_eps)
        h = F.gelu(y + res, approximate="tanh")
        res = h
    pooled = h.mean(dim=-1)  # [B, width]
    return pooled @ params["head"]["w"] + params["head"]["b"]
