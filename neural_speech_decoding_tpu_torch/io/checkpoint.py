"""Reference PyTorch checkpoint (.pth) ingestion.

The reference ships its decoder as a PyTorch state_dict of an `EEG_LSTM`
(nn.LSTM + attention Linear + LayerNorm + MLP head). The port reads it with
`torch.load(..., weights_only=True)`, which refuses anything but tensors
and plain containers, and maps it onto the parameter pytree of
models/lstm.py the way neural_speech_decoding_tpu/io/checkpoint.py:183-221
does: right-multiplication layouts and one folded LSTM bias per layer.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "load_torch_checkpoint",
    "load_decoder_params",
    "torch_lstm_state_to_params",
]


def load_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """Read a PyTorch checkpoint into `{key: np.ndarray}`. Accepts a raw
    state_dict and the `{"state_dict": ...}` wrapper the reference
    tolerates."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint did not contain a state_dict: {type(obj)}")
    out = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"state_dict entry {k!r} is not a tensor")
        out[k] = v.detach().to(torch.float32).numpy()
    return out


def torch_lstm_state_to_params(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """EEG_LSTM state_dict -> decoder parameter pytree (numpy leaves).

    Torch layouts per layer l: weight_ih_l{l} [4H, in], weight_hh_l{l}
    [4H, H], bias_ih/bias_hh [4H], gate rows in (i, f, g, o) order. The
    pytree stores w_ih [in, 4H], w_hh [H, 4H] and b = bias_ih + bias_hh.
    """
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731

    layers = []
    l = 0
    while f"lstm.weight_ih_l{l}" in state:
        layers.append(
            {
                "w_ih": f32(state[f"lstm.weight_ih_l{l}"].T),
                "w_hh": f32(state[f"lstm.weight_hh_l{l}"].T),
                "b": f32(state[f"lstm.bias_ih_l{l}"] + state[f"lstm.bias_hh_l{l}"]),
            }
        )
        l += 1
    if not layers:
        raise KeyError("no lstm.weight_ih_l0 in state_dict")

    return {
        "lstm": layers,
        "attn": {
            "w": f32(state["attn.weight"].reshape(-1)),  # [H]
            # ascontiguousarray promotes 0-d to 1-d, so cast first
            "b": f32(state["attn.bias"]).reshape(()),
        },
        "ln": {"scale": f32(state["ln.weight"]), "bias": f32(state["ln.bias"])},
        "fc1": {"w": f32(state["fc.0.weight"].T), "b": f32(state["fc.0.bias"])},
        "fc2": {"w": f32(state["fc.3.weight"].T), "b": f32(state["fc.3.bias"])},
    }


def load_decoder_params(path) -> Dict[str, Any]:
    """.pth file -> decoder parameter pytree (numpy leaves); pass it through
    io/from_jax.params_from_jax to put it on a device."""
    return torch_lstm_state_to_params(load_torch_checkpoint(path))
