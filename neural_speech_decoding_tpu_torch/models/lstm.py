"""EEG LSTM decoder: initialisation, train mode and eval mode.

Counterpart of neural_speech_decoding_tpu/models/lstm.py:

  x [B, T, C=8]
  -> LSTM layers (hidden 48, torch gate order i, f, g, o; 2 in the shipped
     checkpoints), inter-layer dropout in train mode after every layer but
     the last
  -> attention pooling over time (score Linear(H, 1), softmax over T)
  -> LayerNorm(H) -> Linear(H, 32) -> RReLU -> Dropout -> Linear(32, classes)

Two recurrences, as in the JAX package:

  * the streaming two-layer loop (JAX :261-397), the serving path in eval
    mode for two float32 layers: both layers in ONE pipelined step loop of
    T+1 steps (at step s layer 1 consumes x_s while layer 2 consumes layer
    1's output of step s-1 from the carry), one [B, 2H+C] x [2H+C, 8H]
    matmul a step, and the attention pooled online in the carry under the
    constant softmax shift S = b + ||w_attn||_1 (|h2| < 1 bounds every
    score by S);
  * the per-layer recurrence `_lstm_layer` (JAX :89-171): the input
    projection of all T steps hoisted into one matmul, then a step loop of
    one [B, H] x [H, 4H] matmul and the gate math, in `recurrence_dtype`
    (bfloat16 is the turbo mode), optionally rematerialised in chunks
    (`remat_chunks`). Training, other depths, bfloat16, and the eval mode
    with the fused or streaming scan switched off take it; the JAX
    package's materialising fused two-layer scan (JAX :174-258) computes
    the same values up to summation order and is not ported.

RReLU: eval mode takes the mean slope (lower + upper) / 2; train mode
draws the slope from U(lower, upper) per element. Randomness comes from the
caller's torch.Generator (models/stochastic.py). Parameters are the JAX
package's pytree with float32 tensor leaves (io/from_jax.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from neural_speech_decoding_tpu_torch.config import DecoderConfig
from neural_speech_decoding_tpu_torch.models.stochastic import dropout, require_generator, uniform_like
from neural_speech_decoding_tpu_torch.ops import gates as gates_ops

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, device=generator.device).uniform_(-bound, bound, generator=generator)


def init_decoder_params(generator: torch.Generator, config: DecoderConfig) -> Params:
    """Torch-default initialisation (JAX :48-86): every weight and bias
    U(-1/sqrt(fan), 1/sqrt(fan)), the two torch LSTM bias vectors folded
    into one drawn as the sum of two; LayerNorm scale 1, bias 0. Float32
    tensors on the generator's device."""
    h = config.hidden_size
    bound = 1.0 / math.sqrt(h)
    layers = []
    for l in range(config.num_layers):
        in_size = config.input_size if l == 0 else h
        layers.append({
            "w_ih": _uniform((in_size, 4 * h), bound, generator),
            "w_hh": _uniform((h, 4 * h), bound, generator),
            "b": _uniform((4 * h,), bound, generator) + _uniform((4 * h,), bound, generator),
        })

    def linear(fan_in: int, fan_out: int) -> Params:
        b = 1.0 / math.sqrt(fan_in)
        return {"w": _uniform((fan_in, fan_out), b, generator), "b": _uniform((fan_out,), b, generator)}

    attn = linear(h, 1)
    dev = generator.device
    return {
        "lstm": layers,
        "attn": {"w": attn["w"].reshape(-1), "b": attn["b"].reshape(())},
        "ln": {"scale": torch.ones(h, device=dev), "bias": torch.zeros(h, device=dev)},
        "fc1": linear(h, 32),
        "fc2": linear(32, config.num_classes),
    }


def _fused_weight(params: Params, gate_math: str):
    """[2H + C, 8H] step weight and the two [4H] biases of the streaming
    loop, with the sigmoid gates' columns pre-halved for the rational gate
    math.

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
    if gate_math != "rational":
        return w, l1["b"], l2["b"]
    half = gates_ops.sigmoid_fold_mask(h_dim, w.dtype, w.device)
    w = w * torch.cat([half, half])[None, :]
    return w, l1["b"] * half, l2["b"] * half


def _lstm_two_layer_streaming(params: Params, x_btc: torch.Tensor, gate_math: str = "rational") -> torch.Tensor:
    """Both LSTM layers + online attention pooling. [B, T, C] -> pooled [B, H]."""
    b, t, c = x_btc.shape
    h_dim = params["lstm"][0]["w_hh"].shape[0]
    w, b1, b2 = _fused_weight(params, gate_math)
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
    layer1 = torch.tensor([True, False], device=x.device)[None, :, None]
    l = torch.zeros((b,), dtype=x.dtype, device=x.device)
    acc = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    for s in range(t + 1):
        x_t = x[:, s] if s < t else zero_x  # one trailing step drains layer 2
        hh = torch.matmul(torch.cat([h.reshape(b, 2 * h_dim), x_t], dim=-1), w)
        i, f, g, o = gates_ops.lstm_gate_block(hh.view(b, 2, 4 * h_dim) + bias, h_dim, gate_math)
        cell = f * cell + i * g
        h = o * gates_ops.cell_tanh(cell, gate_math)
        if s == 0:  # layer 2 has nothing to consume at step 0
            cell = torch.where(layer1, cell, 0.0)
            h = torch.where(layer1, h, 0.0)
            continue
        h2 = h[:, 1]
        wgt = torch.exp(torch.matmul(h2, attn_w) + attn_b - shift)
        l = l + wgt
        acc = acc + wgt[:, None] * h2
    return acc / l[:, None]


def _lstm_layer(
    layer: Params,
    x_btc: torch.Tensor,
    recurrence_dtype: torch.dtype = torch.float32,
    gate_math: str = "rational",
    remat_chunks: int = 0,
) -> torch.Tensor:
    """One LSTM layer over the whole sequence. [B, T, in] -> [B, T, H]
    float32. The input projection (one [B*T, in] x [in, 4H] matmul) and
    the outputs are float32; the recurrent matmul, the gate math and the
    state are in `recurrence_dtype`."""
    b, t, _ = x_btc.shape
    h_dim = layer["w_hh"].shape[0]
    xp = (torch.matmul(x_btc, layer["w_ih"]) + layer["b"]).to(recurrence_dtype)
    w_hh = layer["w_hh"].to(recurrence_dtype)
    if gate_math == "rational":
        # pre-halve the sigmoid gates' columns: one whole-block tanh then
        # covers all four gates (x0.5 is exact)
        half = gates_ops.sigmoid_fold_mask(h_dim, recurrence_dtype, x_btc.device)
        w_hh = w_hh * half[None, :]
        xp = xp * half
    xp_tbh = xp.transpose(0, 1)  # time-major

    def run(h, c, xs):
        outs = []
        for s in range(xs.shape[0]):
            gates = xs[s] + torch.matmul(h, w_hh)
            i, f, g, o = gates_ops.lstm_gate_block(gates, h_dim, gate_math)
            c = f * c + i * g
            h = o * gates_ops.cell_tanh(c, gate_math)
            outs.append(h)
        return h, c, torch.stack(outs)

    h = torch.zeros((b, h_dim), dtype=recurrence_dtype, device=x_btc.device)
    c = torch.zeros_like(h)
    if remat_chunks and remat_chunks > 1:
        if t % remat_chunks:
            raise ValueError(f"remat_chunks={remat_chunks} does not divide T={t}")
        hs = []
        for chunk in xp_tbh.split(t // remat_chunks):
            h, c, part = checkpoint(run, h, c, chunk, use_reentrant=False)
            hs.append(part)
        hs = torch.cat(hs)
    else:
        _, _, hs = run(h, c, xp_tbh)
    return hs.transpose(0, 1).to(torch.float32)


def _rrelu(x: torch.Tensor, config: DecoderConfig, train: bool, generator) -> torch.Tensor:
    if train:
        slope = uniform_like(x, config.rrelu_lower, config.rrelu_upper, generator)
    else:
        slope = (config.rrelu_lower + config.rrelu_upper) / 2.0
    return torch.where(x >= 0, x, x * slope)


def _head(params: Params, out: torch.Tensor, config: DecoderConfig, train: bool, generator) -> torch.Tensor:
    """Attention pooling + LayerNorm + MLP head. [B, T, H] -> [B, classes]."""
    scores = torch.matmul(out, params["attn"]["w"]) + params["attn"]["b"]  # [B, T]
    weights = torch.softmax(scores, dim=1)
    pooled = torch.einsum("bth,bt->bh", out, weights)
    return _head_from_pooled(params, pooled, config, train, generator)


def _head_from_pooled(
    params: Params, pooled: torch.Tensor, config: DecoderConfig, train: bool = False, generator=None
) -> torch.Tensor:
    """LayerNorm (biased variance, eps inside the sqrt) + MLP head.
    [B, H] -> [B, classes]."""
    mean = pooled.mean(dim=-1, keepdim=True)
    var = torch.square(pooled - mean).mean(dim=-1, keepdim=True)
    normed = (pooled - mean) / torch.sqrt(var + config.layernorm_eps)
    normed = normed * params["ln"]["scale"] + params["ln"]["bias"]
    hidden = torch.matmul(normed, params["fc1"]["w"]) + params["fc1"]["b"]
    hidden = _rrelu(hidden, config, train, generator)
    if train:
        hidden = dropout(hidden, config.dropout, generator)
    return torch.matmul(hidden, params["fc2"]["w"]) + params["fc2"]["b"]


def decoder_apply(
    params: Params,
    x_btc: torch.Tensor,
    config: DecoderConfig = DecoderConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits for a batch of windows. [B, T, C] -> [B, classes] float32.
    Train mode draws dropout masks and RReLU slopes from `generator`."""
    require_generator(train, generator)
    if params["fc2"]["b"].shape[0] != config.num_classes:
        raise ValueError(
            f"checkpoint has {params['fc2']['b'].shape[0]} classes, "
            f"config {config.num_classes}"
        )
    try:
        rec_dtype = _DTYPES[config.recurrence_dtype]
    except KeyError:
        raise ValueError(f"unknown recurrence_dtype {config.recurrence_dtype!r}") from None
    x = x_btc.to(torch.float32)
    n_layers = len(params["lstm"])
    if (
        not train
        and config.fused_scan
        and config.streaming_scan
        and n_layers == 2
        and rec_dtype == torch.float32
    ):
        pooled = _lstm_two_layer_streaming(params, x, config.gate_math)
        return _head_from_pooled(params, pooled, config)
    out = x
    for l, layer in enumerate(params["lstm"]):
        out = _lstm_layer(layer, out, rec_dtype, config.gate_math, config.remat_chunks)
        if train and l < n_layers - 1:
            # torch's nn.LSTM drops every layer's output but the last
            out = dropout(out, config.dropout, generator)
    return _head(params, out, config, train, generator)


@torch.no_grad()
def decoder_logits(params: Params, x_btc: torch.Tensor, config: DecoderConfig = DecoderConfig()) -> torch.Tensor:
    """Eval-mode logits (the serving path), without autograd."""
    return decoder_apply(params, x_btc, config, train=False)
