"""Native parameter archives (.npz pytrees).

Reads the layout neural_speech_decoding_tpu/io/params_io.py writes: nested
dict/list pytrees flattened to dot-joined key paths ("lstm.0.w_ih"), where
an integer in a path is a list index. Plain arrays only, no pickle.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_SEP = "."


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
