"""Native parameter archives (.npz pytrees).

The layout of neural_speech_decoding_tpu/io/params_io.py, both ways:
nested dict/list pytrees flattened to dot-joined key paths ("lstm.0.w_ih"),
where an integer in a path is a list index. Plain arrays only, no pickle,
so either package reads what the other writes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

_SEP = "."


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} may not contain {_SEP!r}")
            _flatten(f"{prefix}{_SEP}{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}{_SEP}{i}" if prefix else str(i), v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def save_params_npz(path, params: Any) -> None:
    """Write a pytree (tensor or array leaves, on any device) as a
    compressed .npz of flattened key paths (JAX io/params_io.py:33)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten("", params, flat)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params_npz(path) -> Any:
    """.npz archive -> nested dict/list pytree of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}

    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
