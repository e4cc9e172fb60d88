"""EEG LSTM decoder, eval path.

Counterpart of neural_speech_decoding_tpu/models/lstm.py (the streaming
eval scan, lines 261-397, and the head, 473-494):

  x [B, T, C=8]
  -> 2-layer LSTM (hidden 48, torch gate order i, f, g, o), both layers in
     ONE pipelined step loop of T+1 steps: at step s layer 1 consumes x_s
     while layer 2 consumes layer 1's output of step s-1 from the carry,
     so each step is one [B, 2H+C] x [2H+C, 8H] matmul (layer 2 is idle at
     s = 0 and layer 1's last step feeds nothing)
  -> attention pooling online in the carry, under the constant softmax
     shift S = b + ||w_attn||_1 (|h2| < 1 bounds every score by S)
  -> LayerNorm(48) -> Linear(48, 32) -> RReLU (eval slope 11/48)
     -> Linear(32, classes)

Parameters are the JAX package's pytree with float32 tensor leaves
(io/from_jax.py). The loop is plain PyTorch; training, the per-layer
path and dropout come in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from neural_speech_decoding_tpu_torch.config import DecoderConfig
from neural_speech_decoding_tpu_torch.ops import gates as gates_ops

Params = Dict[str, Any]


def _fused_weight(params: Params):
    """[2H + C, 8H] step weight and the two [4H] biases, with the sigmoid
    gates' columns pre-halved for the rational gate math.

        [h1, h2, x_t] @ [[W_hh1, W_ih2],
                         [    0, W_hh2],
                         [W_ih1,     0]]  = [layer-1 gates | layer-2 gates]
    """
    l1, l2 = params["lstm"]
    h_dim = l1["w_hh"].shape[0]
    c = l1["w_ih"].shape[0]
    zero_hh = torch.zeros_like(l2["w_hh"])
    zero_ih = torch.zeros((c, 4 * h_dim), dtype=l1["w_ih"].dtype, device=l1["w_ih"].device)
    w = torch.cat(
        [
            torch.cat([l1["w_hh"], l2["w_ih"]], dim=1),
            torch.cat([zero_hh, l2["w_hh"]], dim=1),
            torch.cat([l1["w_ih"], zero_ih], dim=1),
        ],
        dim=0,
    )
    half = gates_ops.sigmoid_fold_mask(h_dim, w.dtype, w.device)
    w = w * torch.cat([half, half])[None, :]
    return w, l1["b"] * half, l2["b"] * half


def _lstm_two_layer_streaming(params: Params, x_btc: torch.Tensor) -> torch.Tensor:
    """Both LSTM layers + online attention pooling. [B, T, C] -> pooled [B, H]."""
    b, t, c = x_btc.shape
    h_dim = params["lstm"][0]["w_hh"].shape[0]
    w, b1, b2 = _fused_weight(params)
    attn_w = params["attn"]["w"]
    attn_b = params["attn"]["b"]
    shift = attn_b + attn_w.abs().sum()

    x = x_btc.to(torch.float32)
    zero_x = torch.zeros((b, c), dtype=x.dtype, device=x.device)
    bias = torch.cat([b1, b2]).view(2, 4 * h_dim)
    # both layers' states side by side: [:, 0] is layer 1, [:, 1] layer 2,
    # so one gate-math pass covers both (elementwise, so the same numbers
    # as two passes)
    h = torch.zeros((b, 2, h_dim), dtype=x.dtype, device=x.device)
    cell = torch.zeros_like(h)
    l = torch.zeros((b,), dtype=x.dtype, device=x.device)
    acc = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    for s in range(t + 1):
        x_t = x[:, s] if s < t else zero_x  # one trailing step drains layer 2
        hh = torch.matmul(torch.cat([h.reshape(b, 2 * h_dim), x_t], dim=-1), w)
        i, f, g, o = gates_ops.lstm_gate_block(hh.view(b, 2, 4 * h_dim) + bias, h_dim)
        cell = f * cell + i * g
        h = o * gates_ops.tanh(cell)
        if s == 0:  # layer 2 has nothing to consume at step 0
            cell[:, 1] = 0.0
            h[:, 1] = 0.0
            continue
        h2 = h[:, 1]
        wgt = torch.exp(torch.matmul(h2, attn_w) + attn_b - shift)
        l = l + wgt
        acc = acc + wgt[:, None] * h2
    return acc / l[:, None]


def _head_from_pooled(params: Params, pooled: torch.Tensor, config: DecoderConfig) -> torch.Tensor:
    """LayerNorm (biased variance, eps inside the sqrt) + MLP head, eval mode.
    [B, H] -> [B, classes]."""
    mean = pooled.mean(dim=-1, keepdim=True)
    var = torch.square(pooled - mean).mean(dim=-1, keepdim=True)
    normed = (pooled - mean) / torch.sqrt(var + config.layernorm_eps)
    normed = normed * params["ln"]["scale"] + params["ln"]["bias"]
    hidden = torch.matmul(normed, params["fc1"]["w"]) + params["fc1"]["b"]
    slope = (config.rrelu_lower + config.rrelu_upper) / 2.0
    hidden = torch.where(hidden >= 0, hidden, hidden * slope)
    return torch.matmul(hidden, params["fc2"]["w"]) + params["fc2"]["b"]


@torch.no_grad()
def decoder_logits(params: Params, x_btc: torch.Tensor, config: DecoderConfig = DecoderConfig()) -> torch.Tensor:
    """Eval-mode logits for a batch of windows. [B, T, C] -> [B, classes]."""
    if len(params["lstm"]) != 2:
        raise NotImplementedError(
            "the port runs the two-layer streaming LSTM only; other depths are "
            "listed in ROADMAP.md"
        )
    if params["fc2"]["b"].shape[0] != config.num_classes:
        raise ValueError(
            f"checkpoint has {params['fc2']['b'].shape[0]} classes, "
            f"config {config.num_classes}"
        )
    pooled = _lstm_two_layer_streaming(params, x_btc)
    return _head_from_pooled(params, pooled, config)
