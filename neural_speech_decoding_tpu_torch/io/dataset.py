"""Trial dataset loader (host-side numpy; the port's own copy).

Counterpart of neural_speech_decoding_tpu/io/dataset.py. The dataset is a
directory of CSV files, one 5 s trial each: 625 rows x 8 comma-separated
columns, no header, the class given by the filename prefix
`<class>_<uuid4>.csv`. The files are already detrended and band-filtered
by the collector chain, so training applies only the MAI filter on top.

`split` draws the same stratified split as the JAX package from the same
seed (numpy's default_rng), so both frameworks train on the same trials.
`default_data_dir` reads $NSD_DATA_DIR only: the port reads no data
outside the paths its caller names.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from neural_speech_decoding_tpu_torch.config import THREE_CLASS_PREFIXES

_ENV_DATA_DIR = "NSD_DATA_DIR"


def default_data_dir() -> Optional[Path]:
    """$NSD_DATA_DIR, else None."""
    env = os.environ.get(_ENV_DATA_DIR)
    return Path(env) if env else None


@dataclasses.dataclass
class TrialDataset:
    """A stack of fixed-shape EEG trials.

    windows: [N, T, C] float32 (time-major per trial, channels last)
    labels:  [N] int32, indices into `class_prefixes`
    """

    windows: np.ndarray
    labels: np.ndarray
    class_prefixes: Tuple[str, ...]
    files: Tuple[str, ...]

    def __len__(self) -> int:
        return int(self.windows.shape[0])

    @property
    def num_classes(self) -> int:
        return len(self.class_prefixes)

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=self.num_classes)

    def split(self, val_fraction: float = 0.2, seed: int = 0) -> Tuple["TrialDataset", "TrialDataset"]:
        """Stratified train/val split: per class, a permutation from one
        default_rng(seed), round(n * val_fraction) (at least 1) to val."""
        rng = np.random.default_rng(seed)
        train_idx, val_idx = [], []
        for c in range(self.num_classes):
            idx = rng.permutation(np.flatnonzero(self.labels == c))
            n_val = max(1, int(round(len(idx) * val_fraction))) if len(idx) else 0
            val_idx.extend(idx[:n_val])
            train_idx.extend(idx[n_val:])
        return self._take(np.sort(train_idx)), self._take(np.sort(val_idx))

    def _take(self, idx: Sequence[int]) -> "TrialDataset":
        idx = np.asarray(idx, dtype=np.int64)
        return TrialDataset(
            windows=self.windows[idx],
            labels=self.labels[idx],
            class_prefixes=self.class_prefixes,
            files=tuple(self.files[i] for i in idx),
        )


def parse_label(filename: str, prefixes: Sequence[str]) -> Optional[int]:
    """Class index of `<prefix>_...` (case-insensitive), else None."""
    stem = filename.lower()
    for i, p in enumerate(prefixes):
        if stem.startswith(p + "_"):
            return i
    return None


def _read_trial_csv(path: Path) -> np.ndarray:
    # pandas' C parser is ~10x faster than np.loadtxt on these small files
    try:
        import pandas as pd

        return pd.read_csv(path, header=None, dtype=np.float64).to_numpy().ravel()
    except ImportError:
        return np.loadtxt(path, delimiter=",", dtype=np.float64).ravel()


def load_trials(
    data_dir: Optional[os.PathLike] = None,
    class_prefixes: Sequence[str] = THREE_CLASS_PREFIXES,
    expected_samples: int = 625,
    expected_channels: int = 8,
    strict_shape: bool = True,
) -> TrialDataset:
    """Every `<class>_*.csv` trial under `data_dir` whose prefix is in
    `class_prefixes`, sorted by filename."""
    if data_dir is None:
        data_dir = default_data_dir()
    if data_dir is None:
        raise FileNotFoundError("No trial data directory: pass data_dir or set $NSD_DATA_DIR")
    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"Not a directory: {data_dir}")

    files, labels, windows = [], [], []
    for path in sorted(data_dir.glob("*.csv")):
        label = parse_label(path.name, class_prefixes)
        if label is None:
            continue
        flat = _read_trial_csv(path)
        n = flat.size // expected_channels
        if strict_shape and n != expected_samples:
            raise ValueError(
                f"{path.name}: expected {expected_samples}x{expected_channels}, got {flat.size} values"
            )
        windows.append(flat.reshape(n, expected_channels).astype(np.float32))
        labels.append(label)
        files.append(path.name)

    if not windows:
        raise FileNotFoundError(f"No matching trial CSVs under {data_dir}")
    return TrialDataset(
        windows=np.stack(windows, axis=0),
        labels=np.asarray(labels, dtype=np.int32),
        class_prefixes=tuple(class_prefixes),
        files=tuple(files),
    )


def write_synthetic_trials(out_dir: os.PathLike, per_class: int, seed: int = 0) -> Path:
    """Write `per_class` synthetic 3-class trials in the dataset's format,
    for running the training and evaluation tools where no recorded
    dataset is at hand. Per trial, sinusoids at random frequencies plus
    noise as 8 sources are mixed into the channels by the class's own
    matrix, so that the classes differ in covariance and a decoder can
    learn them. Returns `out_dir`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    samples, channels = 625, 8
    rng = np.random.default_rng(seed)
    mixes = [np.eye(channels) + 0.6 * rng.standard_normal((channels, channels)) for _ in THREE_CLASS_PREFIXES]
    t = np.arange(samples) / 125.0
    for k, (prefix, mix) in enumerate(zip(THREE_CLASS_PREFIXES, mixes)):
        for i in range(per_class):
            src = np.sin(2 * np.pi * rng.uniform(4, 30, channels) * t[:, None] + rng.uniform(0, 2 * np.pi, channels))
            x = 10.0 * (src + 0.5 * rng.standard_normal((samples, channels))) @ mix.T
            np.savetxt(out_dir / f"{prefix}_{k}{i:03d}.csv", x, delimiter=",", fmt="%.7f")
    return out_dir
