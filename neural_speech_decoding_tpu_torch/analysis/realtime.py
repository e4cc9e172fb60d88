"""Real-time filter analysis CLI, the headless equivalent of the reference's
live demo (reference: MindsAI/examples/Minds_AI_Filter_Real-time_Signal_
Analysis.py): stream from a board (synthetic by default), roll fixed
windows, optionally inject noise (burst/flatline/sine/white), detrend ->
Kuramoto filter -> per-window SNR console lines.

Counterpart of neural_speech_decoding_tpu/analysis/realtime.py, on the
port's boards and noise injectors. Each window is cast to float32, as in
JAX, and filtered in "highest" mode (float64) on the device, CUDA unless
the caller names another.

  python -m neural_speech_decoding_tpu_torch.analysis.realtime \\
      --board synthetic --speed 16 --windows 10 --inject burst [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from neural_speech_decoding_tpu_torch.analysis.metrics import (
    compute_filter_metrics,
    format_metrics,
)
from neural_speech_decoding_tpu_torch.ops.kuramoto import KuramotoSpatialFilter
from neural_speech_decoding_tpu_torch.runtime.board import open_board
from neural_speech_decoding_tpu_torch.train.augment import KINDS, inject_noise_np
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def run_realtime(
    board,
    n_windows: int = 10,
    window_seconds: float = 1.0,
    lambd: float = 1e-25,
    channel: int = 0,
    inject: str = "",
    seed: int = 0,
    on_window=None,
    timeout: float = 120.0,
    device: DeviceLike = None,
):
    """Stream `n_windows` windows and return their metrics list."""
    window_filter = KuramotoSpatialFilter(lambd, device=device)
    rng = np.random.default_rng(seed)
    fs = board.get_sampling_rate(board.get_board_id())
    n = max(1, int(window_seconds * fs))
    speed = getattr(board, "speed", 1.0)

    results = []
    deadline = time.time() + timeout
    last_count = -1
    while len(results) < n_windows and time.time() < deadline:
        if board.get_board_data_count() < n:
            time.sleep(0.01)
            continue
        data = board.get_current_board_data(n)
        count = int(data[0, -1])  # counter row: skip duplicate windows
        if count == last_count:
            time.sleep(window_seconds / (10 * speed))
            continue
        last_count = count

        eeg_tc = data[board.eeg_channels, :].T.astype(np.float64)  # [T, C]
        if inject:
            eeg_tc = inject_noise_np(eeg_tc, inject, rng, strength=2.0)
        raw_tc = eeg_tc - eeg_tc.mean(axis=0, keepdims=True)
        filt_ct = window_filter.transform(raw_tc.astype(np.float32).T)
        m = compute_filter_metrics(raw_tc.T, filt_ct, fs=fs, channel=channel, lambd=lambd)
        results.append(m)
        if on_window is not None:
            on_window(len(results) - 1, m)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Real-time Kuramoto-filter analysis (PyTorch port)")
    ap.add_argument("--board", default="synthetic")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--window-seconds", type=float, default=1.0)
    ap.add_argument("--lambda", dest="lambd", type=float, default=1e-25)
    ap.add_argument("--channel", type=int, default=0)
    ap.add_argument("--inject", default="", choices=("",) + KINDS)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    board = open_board(args.board, speed=args.speed)
    board.prepare_session()
    board.start_stream()
    try:
        run_realtime(
            board,
            n_windows=args.windows,
            window_seconds=args.window_seconds,
            lambd=args.lambd,
            channel=args.channel,
            inject=args.inject,
            on_window=lambda i, m: print(f"win {i:03d} {format_metrics(m)}", flush=True),
            device=dev,
        )
    finally:
        board.stop_stream()
        board.release_session()


if __name__ == "__main__":
    main()
