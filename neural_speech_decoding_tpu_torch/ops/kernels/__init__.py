"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

A wrapper launches its kernel for a CUDA tensor and takes the twin only for
a CPU tensor; it adds one to LAUNCHES[name] where it launches the kernel
and nowhere else, so a run can show that a path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

# launch counter -> the source csrc/<source>.cu that holds its kernel
SOURCES: Dict[str, str] = {
    "kuramoto_pair_sums": "kuramoto_pair_sums",
    "bandcov_grams": "bandcov_grams",
    "logcov_feats": "logcov_feats",
    "logcov_feats_chebyshev": "logcov_feats",
    "logm_clenshaw": "logm_clenshaw",
    "iir_cascade": "iir_cascade",
}
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
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
