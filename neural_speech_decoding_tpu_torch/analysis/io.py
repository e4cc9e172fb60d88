"""Robust signal-file intake for analysis tooling (the port's own copy of
neural_speech_decoding_tpu/analysis/io.py: stdlib and numpy only).

Parity with the reference offline tool's intake behavior (reference:
MindsAI/examples/Minds_AI_Filter_Offline_Signal_Analysis.py:63-258):
numeric CSV reading that tolerates headers/index columns and either
delimiter, orientation auto-detection ([C, T] vs [T, C]), unit
auto-detection (volts/millivolts/microvolts -> microvolts), and a stdlib
EDF/EDF+ reader (no pyedflib needed; golden-tested against the metrics
JSON the reference ships next to its eeg.edf).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def read_numeric_csv(path) -> np.ndarray:
    """Read a CSV of numbers into a 2D float64 array. Tolerates a header
    row, an index column, and ',' or whitespace delimiters."""
    path = Path(path)
    text = path.read_text()
    delim = "," if "," in text.splitlines()[0] or "," in text else None

    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split(",") if delim else line.split()
        vals = []
        ok = True
        for p in parts:
            p = p.strip()
            if not p:
                continue
            try:
                vals.append(float(p))
            except ValueError:
                ok = False
                break
        if ok and vals:
            rows.append(vals)
    if not rows:
        raise ValueError(f"{path.name}: no numeric rows found")
    width = max(len(r) for r in rows)
    rows = [r for r in rows if len(r) == width]
    arr = np.asarray(rows, dtype=np.float64)
    # drop a leading index column (strictly increasing integers)
    if arr.shape[1] > 2:
        col0 = arr[:, 0]
        if np.all(np.diff(col0) > 0) and np.allclose(col0, np.round(col0)):
            arr = arr[:, 1:]
    return arr


def detect_orientation(arr: np.ndarray, max_channels: int = 64) -> np.ndarray:
    """Return data as [C, T]: EEG recordings always have far more samples
    than channels, so the short axis is channels."""
    if arr.ndim != 2:
        raise ValueError(f"expected 2D, got {arr.shape}")
    r, c = arr.shape
    if r <= max_channels < c:
        return arr
    if c <= max_channels < r:
        return arr.T
    # both small or both large: shorter axis = channels
    return arr if r <= c else arr.T


def detect_unit_scale(arr: np.ndarray) -> Tuple[float, str]:
    """Guess the unit from magnitudes and return (scale_to_uV, name).
    EEG is ~0.1-200 uV: values ~1e-5 are volts, ~1e-2 millivolts,
    ~1-100 microvolts, ~1e3+ nanovolts."""
    mag = float(np.median(np.abs(arr[arr != 0]))) if np.any(arr != 0) else 0.0
    if mag == 0.0:
        return 1.0, "microvolts"
    if mag < 1e-3:
        return 1e6, "volts"
    if mag < 1.0:
        return 1e3, "millivolts"
    if mag > 5e3:
        return 1e-3, "nanovolts"
    return 1.0, "microvolts"


class EdfHeader:
    """Parsed EDF/EDF+ header (the fixed-layout ASCII block)."""

    def __init__(self, raw: bytes):
        if len(raw) < 256:
            raise ValueError("EDF header truncated (< 256 bytes)")

        def field(off: int, n: int) -> str:
            return raw[off : off + n].decode("ascii", errors="replace").strip()

        self.version = field(0, 8)
        self.patient = field(8, 80)
        self.recording = field(88, 80)
        self.start_date = field(168, 8)
        self.start_time = field(176, 8)
        self.header_bytes = int(field(184, 8))
        self.reserved = field(192, 44)
        self.n_records = int(field(236, 8))
        self.record_seconds = float(field(244, 8))
        self.n_signals = int(field(252, 4))
        if self.n_signals <= 0:
            raise ValueError("EDF declares no signals")

        per = raw[256 : 256 + 256 * self.n_signals]
        if len(per) < 256 * self.n_signals:
            raise ValueError("EDF per-signal header truncated")
        ns = self.n_signals

        def col(off: int, width: int):
            base = off * ns
            return [
                per[base + i * width : base + (i + 1) * width]
                .decode("ascii", errors="replace")
                .strip()
                for i in range(ns)
            ]

        # field byte offsets within the per-signal block, in field order:
        # label 16, transducer 80, phys dim 8, phys min 8, phys max 8,
        # dig min 8, dig max 8, prefiltering 80, samples/record 8
        self.labels = col(0, 16)
        self.phys_dim = col(16 + 80, 8)
        self.phys_min = [float(v) for v in col(16 + 80 + 8, 8)]
        self.phys_max = [float(v) for v in col(16 + 80 + 16, 8)]
        self.dig_min = [float(v) for v in col(16 + 80 + 24, 8)]
        self.dig_max = [float(v) for v in col(16 + 80 + 32, 8)]
        self.samples_per_record = [
            int(v) for v in col(16 + 80 + 40 + 80, 8)
        ]

    def is_annotation(self, i: int) -> bool:
        return self.labels[i].upper().startswith("EDF ANNOTATIONS")


def read_edf_numeric(path) -> Tuple[np.ndarray, float]:
    """Read an EDF/EDF+ file into ([C, T] float64 physical values, fs).

    Stdlib implementation of the fixed-layout EDF format (the reference
    gates this on pyEDFlib: Minds_AI_Filter_Offline_Signal_Analysis.py:
    197-226); annotation channels are skipped, a uniform sampling rate is
    required across the data channels (same constraint as the reference),
    and a truncated final record is dropped rather than failing.
    """
    raw = Path(path).read_bytes()
    hdr = EdfHeader(raw)
    ns = hdr.n_signals
    rec_samples = hdr.samples_per_record
    rec_words = sum(rec_samples)
    if hdr.record_seconds <= 0:
        raise ValueError(
            "EDF declares a zero-duration data record (annotation-only "
            "EDF+); no sampled signals to read"
        )
    if rec_words <= 0:
        raise ValueError("EDF declares zero samples per data record")

    data_idx = [i for i in range(ns) if not hdr.is_annotation(i)]
    if not data_idx:
        raise ValueError("EDF contains only annotation channels")
    rates = {rec_samples[i] / hdr.record_seconds for i in data_idx}
    if len(rates) > 1:
        raise ValueError(
            f"EDF has mixed sampling rates across channels ({sorted(rates)}); "
            "uniform-fs channels required"
        )
    fs = rates.pop()
    if fs <= 0:
        raise ValueError(
            "EDF data channels declare zero samples per record — no "
            "sampled data to read"
        )

    body = raw[hdr.header_bytes :]
    n_complete = len(body) // (rec_words * 2)
    n_records = (
        min(hdr.n_records, n_complete) if hdr.n_records >= 0 else n_complete
    )
    if n_records <= 0:
        raise ValueError("EDF appears empty or zero-length")

    words = np.frombuffer(
        body[: n_records * rec_words * 2], dtype="<i2"
    ).reshape(n_records, rec_words)
    # slice each signal's samples out of the interleaved record layout
    offsets = np.cumsum([0] + rec_samples)
    channels = []
    for i in data_idx:
        dig = words[:, offsets[i] : offsets[i + 1]].reshape(-1).astype(np.float64)
        dmin, dmax = hdr.dig_min[i], hdr.dig_max[i]
        pmin, pmax = hdr.phys_min[i], hdr.phys_max[i]
        gain = (pmax - pmin) / (dmax - dmin) if dmax != dmin else 1.0
        channels.append(dig * gain + (pmin - gain * dmin))
    t = min(len(c) for c in channels)
    return np.stack([c[:t] for c in channels]), float(fs)
