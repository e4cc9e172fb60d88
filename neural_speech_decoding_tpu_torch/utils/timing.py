"""Latency / throughput observability.

Own copy of neural_speech_decoding_tpu/utils/timing.py (the port imports
nothing of the JAX package): windows/sec and trial-to-prediction latency
are the runtime's first-class metrics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List


class Stopwatch:
    """Monotonic stopwatch; `lap()` returns seconds since last lap."""

    def __init__(self):
        self._t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        return dt


@dataclass
class LatencyStats:
    """Streaming latency accumulator with exact percentiles.

    Samples are kept (bounded) — trial counts here are tiny compared to
    memory; for long-running streams the reservoir cap keeps it bounded.
    """

    name: str = "latency"
    unit: str = "s"
    max_samples: int = 100_000
    samples: List[float] = field(default_factory=list)

    def record(self, value: float) -> None:
        if len(self.samples) < self.max_samples:
            self.samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return float("nan")
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        xs = sorted(self.samples)
        return {
            "count": len(xs),
            "mean": sum(xs) / len(xs),
            "min": xs[0],
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": xs[-1],
        }

    def __str__(self) -> str:
        s = self.summary()
        if not s.get("count"):
            return f"{self.name}: no samples"
        return (
            f"{self.name}: n={s['count']} p50={s['p50'] * 1e3:.2f}ms "
            f"p90={s['p90'] * 1e3:.2f}ms p99={s['p99'] * 1e3:.2f}ms"
        )
