"""JAX parameter pytrees -> the port's parameters.

The JAX package keeps model parameters as nested dicts/lists of arrays
(models/lstm.py: {"lstm": [{"w_ih", "w_hh", "b"}, ...], "attn", "ln",
"fc1", "fc2"}). The port keeps the same keys and layouts, as float32
tensors on one device, so both packages compute the same thing from the
same numbers. The .npz loader, the .pth loader and the tests all come
through here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Nested dict/list of array-likes (numpy or JAX arrays, or tensors on
    any device) -> the same structure of contiguous float32 tensors on
    `device`, always new copies."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):  # a copy, as for array leaves
        return tree.detach().to(device=device, dtype=torch.float32, copy=True).contiguous()
    # np.array, not np.ascontiguousarray: the latter promotes 0-d leaves
    # (the attention bias) to 1-d
    arr = np.array(np.asarray(tree), dtype=np.float32, order="C")
    return torch.from_numpy(arr).to(device)
