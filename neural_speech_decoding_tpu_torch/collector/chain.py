"""Collection-side recording chain.

Counterpart of neural_speech_decoding_tpu/collector/chain.py. On a
recording-flag rising edge the reference's RecordingProcess grabs the last
625 samples from the board, runs the per-channel filter chain (constant
detrend, 40/50/60 Hz bandstops, 3-48 Hz bandpass, zero-phase), rounds to 7
decimals, turns -0 into 0, and appends the [625, 8] window to
`<label>_<uuid4>.csv` as "%.7f" rows (reference:
Neural_decoding_data_collector.py:97-142). The label argument is honoured
(the reference hard-codes `backgroundnoise_`; pass that label to get it).

The chain is ops/iir.collector_filter_chain_batch's dense operator
product, in float64, on the caller's device (the card unless
`device="cpu"`), so the file's bytes do not depend on where it ran.
"""

from __future__ import annotations

import uuid
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.ops.iir import collector_filter_chain_batch
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def preprocess_trial(
    raw_tc: np.ndarray,
    fs: float = 125.0,
    padtype: Optional[str] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Filter one raw [T, C] window and apply the reference's rounding
    (7 decimals, -0 -> 0). padtype=None (default) is the pad-free
    zero-phase pass that produced the shipped dataset; "odd" gives scipy's
    edge extension."""
    x = torch.as_tensor(np.asarray(raw_tc, dtype=np.float64)[None], device=resolve_device(device))
    out = collector_filter_chain_batch(x, fs, padtype)[0].cpu().numpy()
    out = np.round(out, decimals=7)
    out[out == 0.0] = 0.0  # normalize -0.0 (reference: collector :133-135)
    return out


def write_trial_csv(path, data_tc: np.ndarray) -> None:
    """Append a [T, C] window as '%.7f' comma-separated rows (reference:
    collector :136-139)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        np.savetxt(f, data_tc, delimiter=",", fmt="%.7f")


def record_trial(
    board,
    label: str,
    out_dir,
    window_samples: int = 625,
    fs: Optional[float] = None,
    device: DeviceLike = None,
) -> Optional[Path]:
    """Capture, filter and persist one labelled trial from a live board.
    Returns the written path, or None if the board had no full window yet."""
    device = resolve_device(device)  # raise before touching the board
    data = board.get_current_board_data(window_samples)
    if data.shape[1] < window_samples:
        return None
    eeg_tc = data[board.eeg_channels, :].T  # [T, C]
    fs = float(fs if fs is not None else board.get_sampling_rate(board.get_board_id()))
    filtered = preprocess_trial(eeg_tc, fs=fs, device=device)
    path = Path(out_dir) / f"{label}_{uuid.uuid4()}.csv"
    write_trial_csv(path, filtered)
    return path
