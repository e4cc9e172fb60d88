"""EEGNet-style temporal + spatial convolutional encoder.

Counterpart of neural_speech_decoding_tpu/models/eegnet.py:28-130
(initialisation, train and eval mode):

  x [B, T, C] -> [B, 1, C, T]
  -> temporal conv bank (F1 = 8 kernels of 64 samples, "SAME")
  -> depthwise spatial conv over the C electrodes (F1 groups, D = 2 each)
  -> per-sample LayerNorm over (feature, H, W) -> ELU -> average pool 4
  -> depthwise temporal conv (16 samples, "SAME") -> pointwise conv to F2
  -> LayerNorm -> ELU -> average pool 8 -> flatten -> linear head

with dropout after each of the two pools in train mode.

JAX's "SAME" padding of an even kernel k puts (k - 1) // 2 samples before
and k // 2 after (31 / 32 for 64, 7 / 8 for 16); the port pads so
explicitly and convolves VALID. Pooling is VALID (floor): 625 -> 156 -> 19,
so the head is F2 x 19 = 304 wide. Parameters are the JAX pytree with
float32 tensor leaves (io/from_jax.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from neural_speech_decoding_tpu_torch.models.stochastic import dropout, require_generator

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EEGNetConfig:
    num_channels: int = 8
    num_classes: int = 3
    temporal_filters: int = 8  # F1
    depth_multiplier: int = 2  # D
    separable_filters: int = 16  # F2
    temporal_kernel: int = 64
    separable_kernel: int = 16
    pool1: int = 4
    pool2: int = 8
    dropout: float = 0.5
    window_samples: int = 625


def init_eegnet_params(generator: torch.Generator, cfg: EEGNetConfig) -> Params:
    """He-normal convolutions and head (JAX :44-66), LayerNorm scale 1 and
    bias 0, zero head bias; float32 on the generator's device."""
    f1, d, f2 = cfg.temporal_filters, cfg.depth_multiplier, cfg.separable_filters
    dev = generator.device

    def he(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) * math.sqrt(2.0 / fan_in)

    feat = f2 * (cfg.window_samples // cfg.pool1 // cfg.pool2)
    return {
        "conv_t": he((f1, 1, 1, cfg.temporal_kernel), cfg.temporal_kernel),
        "conv_s": he((f1 * d, 1, cfg.num_channels, 1), cfg.num_channels),
        "conv_dw": he((f1 * d, 1, 1, cfg.separable_kernel), cfg.separable_kernel),
        "conv_pw": he((f2, f1 * d, 1, 1), f1 * d),
        "ln1": {"scale": torch.ones(f1 * d, device=dev), "bias": torch.zeros(f1 * d, device=dev)},
        "ln2": {"scale": torch.ones(f2, device=dev), "bias": torch.zeros(f2, device=dev)},
        "head": {"w": he((feat, cfg.num_classes), feat), "b": torch.zeros(cfg.num_classes, device=dev)},
    }


def _conv_same_time(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """NCHW conv with a [O, I, 1, K] kernel, "SAME" along time as XLA pads it."""
    k = w.shape[-1]
    return F.conv2d(F.pad(x, ((k - 1) // 2, k // 2)), w, groups=groups)


def _channel_layernorm(x: torch.Tensor, ln: Params, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each sample over (C, H, W), population variance; scale and
    bias per feature channel."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * ln["scale"][None, :, None, None] + ln["bias"][None, :, None, None]


def _avgpool_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """VALID average pool of k samples along time (a tail shorter than k is
    dropped), as a sum divided by k."""
    n = x.shape[-1] // k
    return x[..., : n * k].reshape(*x.shape[:-1], n, k).sum(dim=-1) / float(k)


def eegnet_apply(
    params: Params,
    x_btc: torch.Tensor,
    cfg: EEGNetConfig = EEGNetConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B, T, C] -> logits [B, num_classes]; train mode drops out after
    each pool with masks drawn from `generator`."""
    require_generator(train, generator)
    b = x_btc.shape[0]
    x = x_btc.to(torch.float32).transpose(1, 2)[:, None]  # [B, 1, C, T]
    h = _conv_same_time(x, params["conv_t"])  # [B, F1, C, T]
    h = F.conv2d(h, params["conv_s"], groups=params["conv_t"].shape[0])  # [B, F1*D, 1, T]
    h = F.elu(_channel_layernorm(h, params["ln1"]))
    h = _avgpool_time(h, cfg.pool1)
    if train:
        h = dropout(h, cfg.dropout, generator)
    h = _conv_same_time(h, params["conv_dw"], groups=h.shape[1])  # depthwise temporal
    h = F.conv2d(h, params["conv_pw"])  # pointwise -> F2
    h = F.elu(_channel_layernorm(h, params["ln2"]))
    h = _avgpool_time(h, cfg.pool2)
    if train:
        h = dropout(h, cfg.dropout, generator)
    return h.reshape(b, -1) @ params["head"]["w"] + params["head"]["b"]
