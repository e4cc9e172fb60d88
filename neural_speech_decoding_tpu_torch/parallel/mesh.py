"""A device mesh in one process.

Counterpart of neural_speech_decoding_tpu/parallel/mesh.py. The JAX package
runs one controller over a `jax.sharding.Mesh`; the port does the same
with a (dp, tp) grid of `torch.device`s and no process group:

  dp  data parallel over windows (decoding is embarrassingly parallel
      over windows)
  tp  the second axis: tensor-parallel parameter slices
      (parallel/sharding.shard_params_tp) and the ensemble's member shards
      (runtime/ensemble.py, shard_members)

A device may repeat: `["cpu"] * 8` on the CPU, `["cuda:0"] * 2` on one card,
or distinct cards. The mesh keeps one worker thread per distinct device;
`Mesh.run` hands each shard's work to its device's thread, which makes that
device current (the current CUDA device is per thread). Shards that share a
device run in order on its thread, so a mesh over one device is
deterministic. A shard's exception is raised in the caller once every
shard has ended: a failed shard fails the call.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_worker = threading.local()  # .device on a mesh worker thread


def mesh_axes(n_devices: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """Pick (dp, tp) for n devices: tp=2 when even and >1, else 1, unless
    given explicitly."""
    if tp is None:
        tp = 2 if (n_devices % 2 == 0 and n_devices > 1) else 1
    if n_devices % tp != 0:
        raise ValueError(f"tp={tp} does not divide {n_devices} devices")
    return n_devices // tp, tp


def _call(device: torch.device, grad: bool, fn: Callable, args: tuple) -> Any:
    """Run fn(*args) on a worker thread with `device` current and the
    caller's grad mode (both are per thread)."""
    on_device = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    outer, _worker.device = getattr(_worker, "device", None), device
    try:
        with on_device, torch.set_grad_enabled(grad):
            return fn(*args)
    finally:
        _worker.device = outer


class Mesh:
    """A (dp, tp) grid of torch devices.

    `grid[i][j]` is the device of dp shard i and tp shard j; `shape` is
    {"dp": .., "tp": ..} (JAX's `mesh.shape`); `distinct` the devices in
    first-seen order; `primary` the first, where results are gathered."""

    def __init__(self, grid: Sequence[Sequence[torch.device]], axis_names: Tuple[str, str] = ("dp", "tp")):
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(tuple(row) for row in grid)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {
            self.axis_names[0]: len(self.grid),
            self.axis_names[1]: len(self.grid[0]),
        }
        self.distinct: Tuple[torch.device, ...] = tuple(dict.fromkeys(d for row in self.grid for d in row))
        self.primary = self.grid[0][0]
        self._executors: Dict[torch.device, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along `axis`, at index 0 of the other axis: the
        devices that hold one shard each when work is split over `axis`."""
        if axis == self.axis_names[0]:
            return tuple(row[0] for row in self.grid)
        if axis == self.axis_names[1]:
            return self.grid[0]
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh has {self.axis_names}")

    def _executor(self, device: torch.device) -> ThreadPoolExecutor:
        with self._lock:
            ex = self._executors.get(device)
            if ex is None:
                ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"mesh-{device}")
                self._executors[device] = ex
            return ex

    def run(self, tasks: Sequence[Tuple[torch.device, Callable, tuple]]) -> list:
        """Run each (device, fn, args) on its device's worker thread and
        return the results in task order. Tasks of one device run in
        order. Every task ends before the first exception (in task order)
        is raised. Called from a worker thread, the tasks run inline, in
        order, on that thread."""
        grad = torch.is_grad_enabled()
        if getattr(_worker, "device", None) is not None:
            return [_call(d, grad, fn, args) for d, fn, args in tasks]
        futures = [self._executor(d).submit(_call, d, grad, fn, args) for d, fn, args in tasks]
        results, error = [], None
        for f in futures:
            try:
                results.append(f.result())
            except Exception as e:  # noqa: BLE001 - re-raised below, after every shard has ended
                if error is None:
                    error = e
        if error is not None:
            raise error
        return results

    def close(self) -> None:
        """Stop the worker threads (they also stop when the mesh is
        collected)."""
        with self._lock:
            executors, self._executors = self._executors, {}
        for ex in executors.values():
            ex.shutdown(wait=True)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[[str(d) for d in row] for row in self.grid]})"


def _normalise(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def primary_device(mesh: Mesh, device=None) -> torch.device:
    """The device a caller of `mesh` runs on: its primary one. A `device`
    that names another raises."""
    if device is not None and _normalise(device) != mesh.primary:
        raise ValueError(f"device {device} is not the mesh's primary device {mesh.primary}")
    return mesh.primary


def make_mesh(
    devices: Optional[Sequence] = None,
    tp: Optional[int] = None,
    axis_names: Tuple[str, str] = ("dp", "tp"),
) -> Mesh:
    """A (dp, tp) mesh over `devices` (default: every visible CUDA device),
    dp and tp from `mesh_axes`. Raises without CUDA when no devices are
    given, on an empty list, and on a mix of device types; never falls
    back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    kinds = {torch.device(d).type for d in devices}
    if not kinds:
        raise ValueError("a mesh needs at least one device")
    if len(kinds) != 1:
        raise ValueError(f"a mesh takes devices of one type, got {sorted(kinds)}")
    if "cuda" in kinds and not torch.cuda.is_available():
        raise RuntimeError("CUDA devices requested but CUDA is not available")
    devs = [_normalise(d) for d in devices]
    dp, tp_ = mesh_axes(len(devs), tp)
    return Mesh([devs[i * tp_ : (i + 1) * tp_] for i in range(dp)], axis_names)
