"""Reductions across the shards of a mesh.

Counterpart of neural_speech_decoding_tpu/parallel/collective.py, whose
shard_map bodies run on every device of the mesh and combine their partial
results with psum / all_gather over 'dp' and pmean over 'tp'. Here every
device of the grid computes its dp shard (the tp devices of a row see the
same windows, as in the JAX package), and the partial results are combined
on the primary device in shard order: summed (or concatenated) over 'dp',
then averaged over 'tp'.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.parallel.mesh import Mesh
from neural_speech_decoding_tpu_torch.parallel.sharding import Replicated, batch_sharding, replicate


def _placed(mesh: Mesh, params: Any) -> Replicated:
    return params if isinstance(params, Replicated) else replicate(mesh, params)


def _grid_tasks(mesh: Mesh, fn: Callable, placed: Replicated, *sharded):
    """One task per device of the grid, row-major: fn(params on the
    device, row i's shard of each array in `sharded`)."""
    tasks = []
    for i, row in enumerate(mesh.grid):
        for d in row:
            tasks.append((d, fn, (placed.on(d),) + tuple(s[i].to(d) for s in sharded)))
    return tasks


def sharded_eval(
    mesh: Mesh,
    apply_fn: Callable,
    params: Any,
    windows: np.ndarray,
    labels: np.ndarray,
) -> Tuple[float, int]:
    """Data-parallel evaluation: each shard decodes its slice of windows
    and counts (correct, total); the counts are summed over 'dp' and
    averaged over 'tp' on the primary device. The batch is padded to a
    multiple of dp with copies of window 0 labelled -1, which count
    nowhere. `params` is a parameter tree or a `Replicated`. Returns
    (accuracy, n_evaluated)."""
    dp = mesh.shape[mesh.axis_names[0]]
    windows = np.asarray(windows, np.float32)
    labels = np.asarray(labels)
    n = windows.shape[0]
    pad = (-n) % dp
    if pad:
        windows = np.concatenate([windows, np.repeat(windows[:1], pad, 0)], 0)
        labels = np.concatenate([labels, np.full(pad, -1, labels.dtype)])
    w_shards = batch_sharding(mesh, torch.from_numpy(windows))
    y_shards = batch_sharding(mesh, torch.from_numpy(labels.astype(np.int64)))

    @torch.no_grad()
    def counts(p, w, y):
        pred = apply_fn(p, w).argmax(-1)
        valid = y >= 0
        return torch.stack([((pred == y) & valid).sum(), valid.sum()])

    parts = mesh.run(_grid_tasks(mesh, counts, _placed(mesh, params), w_shards, y_shards))
    tp = len(mesh.grid[0])
    per_device = torch.stack([p.to(mesh.primary) for p in parts]).view(dp, tp, 2)
    summed = per_device.sum(dim=0).to(torch.float64)  # psum over dp, in shard order
    correct, total = (summed.mean(dim=0)).tolist()  # pmean over tp
    return (correct / total if total else 0.0), int(total)


def all_gather_probs(mesh: Mesh, probs_fn: Callable, params: Any, windows: np.ndarray) -> np.ndarray:
    """Decode dp-sharded windows on every device of the grid and gather
    the probabilities: concatenated over 'dp' in shard order, averaged over
    'tp'. The batch must divide by dp."""
    dp = mesh.shape[mesh.axis_names[0]]
    n = windows.shape[0]
    if n % dp:
        raise ValueError(f"batch {n} not divisible by dp={dp}")
    w_shards = batch_sharding(mesh, torch.as_tensor(np.asarray(windows, np.float32)))

    @torch.no_grad()
    def decode(p, w):
        return probs_fn(p, w)

    parts = mesh.run(_grid_tasks(mesh, decode, _placed(mesh, params), w_shards))
    tp = len(mesh.grid[0])
    columns = [torch.cat([parts[i * tp + j].to(mesh.primary) for i in range(dp)]) for j in range(tp)]
    return torch.stack(columns).mean(dim=0).cpu().numpy()
