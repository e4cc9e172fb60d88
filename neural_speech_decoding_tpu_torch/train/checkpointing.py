"""Training checkpoint / resume.

Counterpart of neural_speech_decoding_tpu/train/checkpointing.py (orbax
there, torch.save here). Each save writes one file
`<directory>/epoch_<N>.pt` holding the epoch, the parameters (float32 CPU
tensors) and the optimizer's state, through a temporary file and a rename,
and keeps the `keep` newest. `restore_train_state` loads the newest with
torch.load(weights_only=True), which unpickles tensors and plain
containers only, and returns the parameters on the devices of the
template's leaves; train/loop.py copies them into the live tensors, loads
the optimizer state, and resumes at the next epoch, as the JAX loop does.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _epochs(directory: Path) -> List[int]:
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for m in (_NAME.match(p.name) for p in directory.iterdir()) if m)


def _path(directory: Path, epoch: int) -> Path:
    return directory / f"epoch_{epoch:08d}.pt"


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def save_train_state(directory, epoch: int, params: Any, opt_state: Any, keep: int = 3) -> None:
    """Save (epoch, params, opt_state) and drop all but the `keep` newest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = _path(directory, epoch)
    tmp = path.with_suffix(".tmp")
    state = {
        "epoch": int(epoch),
        "params": _map(params, lambda t: t.detach().to("cpu", torch.float32).clone()),
        "opt_state": opt_state,
    }
    torch.save(state, tmp)
    os.replace(tmp, path)
    for old in _epochs(directory)[:-keep]:
        _path(directory, old).unlink(missing_ok=True)


def latest_epoch(directory) -> Optional[int]:
    """The newest saved epoch under `directory`, or None."""
    epochs = _epochs(Path(directory))
    return epochs[-1] if epochs else None


def restore_train_state(directory, params_template: Any) -> Tuple[int, Any, Any]:
    """(epoch, params, opt_state) of the newest checkpoint. The parameters
    come back with the template's structure, on its leaves' devices; the
    optimizer state as it was saved (torch's optimizers move it to their
    parameters' devices when they load it)."""
    directory = Path(directory)
    epoch = latest_epoch(directory)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    state = torch.load(_path(directory, epoch), map_location="cpu", weights_only=True)

    def place(template, saved):
        if isinstance(template, dict):
            return {k: place(template[k], saved[k]) for k in template}
        if isinstance(template, (list, tuple)):
            return [place(t, s) for t, s in zip(template, saved)]
        return saved.to(template.device)

    return int(state["epoch"]), place(params_template, state["params"]), state["opt_state"]
