"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

A wrapper launches its kernel for a CUDA tensor and takes the twin only for
a CPU tensor; it adds one to LAUNCHES[name] where it launches the kernel
and nowhere else, so a run can show that a path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

LAUNCHES: Dict[str, int] = {"kuramoto_pair_sums": 0}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    """Snapshot of the launch counts."""
    with _lock:
        return dict(LAUNCHES)
