"""Frontend-shared pure helpers (no UI-framework dependency).

Own copy of neural_speech_decoding_tpu/frontend/common.py; device
snapshots run through the port's `run_trials_ex` on `device` (the card
unless the caller passes device="cpu").
Mock generators reproduce the reference's test mode (reference:
Frontend/app.py:46-66); `normalize_eeg` is the chart z-score contract
(app.py:166-170); `decode_snapshot` is the one backend call both UIs make.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from neural_speech_decoding_tpu_torch.utils.device import DeviceLike

CLASSES: List[str] = ["Food", "Water", "Background Noise"]
CHANNELS = 8
SAMPLE_RATE = 125
WINDOW_SECONDS = 5
SAMPLES = SAMPLE_RATE * WINDOW_SECONDS


def generate_mock_probs(focus_label: str, rng: Optional[np.random.Generator] = None) -> Dict[str, float]:
    rng = rng or np.random.default_rng()
    focus = float(rng.uniform(0.60, 0.70))
    others = [c for c in CLASSES if c != focus_label]
    w = rng.random(len(others))
    w = w / w.sum() if w.sum() else np.full(len(others), 1 / len(others))
    probs = {focus_label: focus}
    for label, weight in zip(others, w):
        probs[label] = (1.0 - focus) * float(weight)
    return probs


def generate_mock_eeg(rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    t = np.linspace(0, WINDOW_SECONDS, SAMPLES, endpoint=False)
    chans = []
    for ch in range(CHANNELS):
        base = np.sin(2 * np.pi * (8 + ch) * t)
        mod = 0.4 * np.sin(2 * np.pi * (2 + ch * 0.2) * t + ch)
        chans.append(base + mod + 0.35 * rng.standard_normal(SAMPLES))
    return np.stack(chans, axis=1)


def normalize_eeg(chunk: np.ndarray) -> np.ndarray:
    """Per-channel z-score with epsilon (reference: app.py:166-170)."""
    mu = chunk.mean(axis=0, keepdims=True)
    sigma = chunk.std(axis=0, keepdims=True) + 1e-6
    return (chunk - mu) / sigma


@dataclass
class Snapshot:
    """One decoding snapshot, UI-framework neutral."""

    word_probs: Dict[str, float] = field(default_factory=lambda: {c: 0.0 for c in CLASSES})
    eeg: Optional[np.ndarray] = None  # normalized [T, C]
    transcript: str = ""
    status: str = ""
    stats_line: str = ""
    timestamp: str = ""

    def to_json_dict(self) -> dict:
        return {
            "word_probs": self.word_probs,
            "eeg": self.eeg.tolist() if self.eeg is not None else None,
            "transcript": self.transcript,
            "status": self.status,
            "stats_line": self.stats_line,
            "timestamp": self.timestamp,
        }


def mock_snapshot(focus_label: str = CLASSES[0], seed: Optional[int] = None) -> Snapshot:
    rng = np.random.default_rng(seed)
    probs = generate_mock_probs(focus_label, rng)
    top = max(probs, key=probs.get)
    return Snapshot(
        word_probs=probs,
        eeg=generate_mock_eeg(rng),
        transcript=f"Predicted: {top}",
        status="Mock snapshot ready.",
        timestamp=time.strftime("%H:%M:%S"),
    )


def decode_snapshot(
    board_spec: str = "replay",
    speed: float = 32.0,
    trials: int = 10,
    model_path: Optional[str] = None,
    family: str = "lstm",
    engine=None,
    device: DeviceLike = None,
) -> Snapshot:
    """Run one device snapshot through the streaming runtime (`engine`,
    or one built lazily on `device`)."""
    from neural_speech_decoding_tpu_torch.runtime.board import open_board
    from neural_speech_decoding_tpu_torch.runtime.tester import run_trials_ex

    board = open_board(board_spec, speed=float(speed))
    result, stats = run_trials_ex(
        trials=int(trials),
        serial_port=board,
        model_path=model_path or None,
        verbose=False,
        model=family,
        engine=engine,
        device=device,
    )
    snap = Snapshot(timestamp=time.strftime("%H:%M:%S"))
    if result.avg_probs is not None:
        n = min(len(CLASSES), len(result.avg_probs))
        snap.word_probs = {CLASSES[i]: float(result.avg_probs[i]) for i in range(n)}
        top = int(np.argmax(result.avg_probs))
        snap.transcript = f"Detected: {CLASSES[top] if top < len(CLASSES) else top}"
        snap.status = "Device snapshot ready."
    else:
        snap.transcript = "No predictions collected."
        snap.status = "No probabilities available."
    if result.avg_chunk is not None:
        snap.eeg = normalize_eeg(result.avg_chunk)
    snap.stats_line = (
        f"{stats.windows_per_second:.2f} windows/s · "
        f"p50 trial→prediction {stats.latency.percentile(50) * 1e3:.1f} ms · "
        f"p50 predict-only {stats.predict_latency.percentile(50) * 1e3:.1f} ms"
    )
    return snap
