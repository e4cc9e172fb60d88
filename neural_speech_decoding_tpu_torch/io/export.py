"""Reference-layout PyTorch checkpoints of a trained LSTM decoder.

Counterpart of neural_speech_decoding_tpu/io/export.py:134-173. The JAX
package writes the .pth by emitting the pickle stream itself; the port has
torch, so `save_torch_checkpoint` is `torch.save` of an OrderedDict of
tensors: the file that torch.load and the reference model's
load_state_dict(strict=True) read, and that both packages' loaders
(io/checkpoint.py) read back.

Torch LSTMs carry two bias vectors a layer (bias_ih, bias_hh) whose sum is
what the cell uses; the pytree folds them, so the export writes the folded
vector as bias_ih and zeros as bias_hh, which computes the same.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_torch_checkpoint", "decoder_params_to_torch_state"]

_DTYPES = (np.float32, np.float64, np.int64, np.int32)


def save_torch_checkpoint(path, state: Dict[str, Any]) -> None:
    """Write `{name: array or tensor}` as a torch.load-able checkpoint."""
    out = collections.OrderedDict()
    for k, v in state.items():
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if arr.dtype not in _DTYPES:
            raise ValueError(f"{k}: unsupported dtype {arr.dtype}")
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)


def decoder_params_to_torch_state(params: Any) -> Dict[str, np.ndarray]:
    """The LSTM pytree -> the reference state_dict layout (the inverse of
    io/checkpoint.torch_lstm_state_to_params), float32 numpy arrays."""

    def f32(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.ascontiguousarray(np.asarray(a), dtype=np.float32)

    state: Dict[str, np.ndarray] = {}
    for l, layer in enumerate(params["lstm"]):
        state[f"lstm.weight_ih_l{l}"] = f32(layer["w_ih"]).T.copy()
        state[f"lstm.weight_hh_l{l}"] = f32(layer["w_hh"]).T.copy()
        state[f"lstm.bias_ih_l{l}"] = f32(layer["b"])
        state[f"lstm.bias_hh_l{l}"] = np.zeros_like(f32(layer["b"]))
    state["ln.weight"] = f32(params["ln"]["scale"])
    state["ln.bias"] = f32(params["ln"]["bias"])
    state["attn.weight"] = f32(params["attn"]["w"]).reshape(1, -1)
    state["attn.bias"] = f32(params["attn"]["b"]).reshape(1)
    state["fc.0.weight"] = f32(params["fc1"]["w"]).T.copy()
    state["fc.0.bias"] = f32(params["fc1"]["b"])
    state["fc.3.weight"] = f32(params["fc2"]["w"]).T.copy()
    state["fc.3.bias"] = f32(params["fc2"]["b"])
    return state
