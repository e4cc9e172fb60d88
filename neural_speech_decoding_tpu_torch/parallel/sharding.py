"""Placing parameters and batches on a mesh, and sharded prediction.

Counterpart of neural_speech_decoding_tpu/parallel/sharding.py. Where the
JAX package annotates shardings and lets GSPMD partition one program, the
port places the pieces itself and runs each shard on its device
(parallel/mesh.Mesh.run):

  * windows split over 'dp' along the leading axis, shard i on the first
    device of grid row i;
  * parameters replicated (one copy on each distinct device), or sliced
    over 'tp' by the JAX package's rules (`_tp_spec_for_leaf`), slice j on
    device grid[i][j] of every row i;
  * a tp-sliced shard gathers its row's slices onto its device before it
    computes (FSDP-style): no model of the repository is too large for one
    card, so the arithmetic is then the replicated one.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.parallel.mesh import Mesh


def batch_sharding(mesh: Mesh, x, axis: str = "dp") -> List[torch.Tensor]:
    """Split the leading (batch) axis of `x` into one equal shard per
    device along `axis`, each shard on its device. Raises when the batch
    does not divide."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    b = int(x.shape[0])
    if b % n:
        raise ValueError(f"batch {b} not divisible by {axis}={n}")
    step = b // n
    return [torch.as_tensor(x[i * step : (i + 1) * step], device=d) for i, d in enumerate(devices)]


def gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Concatenate per-shard tensors, in shard order, on the primary
    device."""
    return torch.cat([p.to(mesh.primary) for p in parts], dim=dim)


class Replicated:
    """One copy of a parameter tree on each distinct device of a mesh."""

    def __init__(self, mesh: Mesh, tree: Any):
        self.mesh = mesh
        self.copies = {d: params_from_jax(tree, d) for d in mesh.distinct}

    def on(self, device: torch.device) -> Any:
        return self.copies[device]

    def row(self, i: int) -> Any:
        """The full tree on the first device of dp row i."""
        return self.copies[self.mesh.grid[i][0]]


def replicate(mesh: Mesh, tree: Any) -> Replicated:
    return Replicated(mesh, tree)


def _keystr(path: Tuple) -> str:
    """A tree path as jax.tree_util.keystr prints it: ['lstm'][0]['w_ih']."""
    return "".join(f"[{k!r}]" for k in path)


def _tp_spec_for_leaf(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Tensor-parallel spec of a decoder parameter leaf, one entry per
    axis, "tp" on the sliced axis (the JAX PartitionSpec's entries).

    LSTM gate matrices [in, 4H] and biases [4H] slice the gate dim; fc1
    slices its output dim; fc2 slices its input dim (row-parallel).
    LayerNorm/attention stay replicated (tiny). As in the JAX package, the
    path is the keystr form, which ends in "']" for a dict key, so the
    bias rule matches no LSTM bias and the biases stay replicated."""
    if "lstm" in path:
        if "w_ih" in path or "w_hh" in path:
            return (None, "tp")
        if path.endswith("b"):
            return ("tp",)
    if "fc1" in path:
        return (None, "tp") if ndim == 2 else ("tp",)
    if "fc2" in path and ndim == 2:
        return ("tp", None)
    return (None,) * ndim


def _map_leaves(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


class TPSharded:
    """A parameter tree sliced over 'tp': `specs` holds each leaf's spec,
    `shards[i][j]` the tree of slices on device grid[i][j] (a leaf with no
    "tp" entry is whole in every slice tree)."""

    def __init__(self, mesh: Mesh, tree: Any):
        self.mesh = mesh
        tp = mesh.shape[mesh.axis_names[1]]
        host = params_from_jax(tree, "cpu")
        self.specs = _map_leaves(lambda path, leaf: _tp_spec_for_leaf(_keystr(path), leaf.dim()), host)

        def slice_of(path, leaf, j):
            spec = _tp_spec_for_leaf(_keystr(path), leaf.dim())
            if "tp" not in spec:
                return leaf
            axis = spec.index("tp")
            if leaf.shape[axis] % tp:
                raise ValueError(f"{_keystr(path)} axis {axis} of {tuple(leaf.shape)} not divisible by tp={tp}")
            return torch.chunk(leaf, tp, dim=axis)[j]

        self.shards = [
            [params_from_jax(_map_leaves(lambda path, leaf, j=j: slice_of(path, leaf, j), host), d)
             for j, d in enumerate(row)]
            for row in mesh.grid
        ]

    def row(self, i: int) -> Any:
        """The full tree of dp row i: its tp slices gathered, in order, onto
        the row's first device."""
        device = self.mesh.grid[i][0]
        parts = self.shards[i]

        def gather_leaf(path, leaf):
            spec = _get(self.specs, path)
            if "tp" not in spec:
                return leaf.to(device)
            return torch.cat([_get(p, path).to(device) for p in parts], dim=spec.index("tp"))

        return _map_leaves(gather_leaf, parts[0])


def _get(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def shard_params_tp(mesh: Mesh, params: Any) -> TPSharded:
    """Place decoder parameters sliced over 'tp' (JAX's rules)."""
    return TPSharded(mesh, params)


def sharded_predict_fn(mesh: Mesh, pipeline_fn: Callable, params: Any, tp_shard: bool = False):
    """`pipeline_fn(params, windows)` with the windows split over 'dp' and
    the parameters replicated (or sliced over 'tp' with `tp_shard`).

    Returns (fn, placed): `fn(placed, windows)` runs each dp shard on the
    first device of its row, with that row's full parameters, and
    concatenates the outputs on the primary device. The batch must divide
    by dp, as the JAX package's sharded arrays must."""
    placed = shard_params_tp(mesh, params) if tp_shard else replicate(mesh, params)
    devices = mesh.axis_devices(mesh.axis_names[0])

    def fn(placed, windows):
        shards = batch_sharding(mesh, windows)
        tasks = [(d, lambda i, w: pipeline_fn(placed.row(i), w), (i, w)) for i, (d, w) in enumerate(zip(devices, shards))]
        return gather(mesh, mesh.run(tasks))

    return fn, placed
