"""Continuous streaming decoder.

Counterpart of neural_speech_decoding_tpu/runtime/stream.py:33-205
(BASELINE.json config 5, "replay -> sliding windows -> 10-trial averaged
softmax"): a board feeds sliding windows (hop < window for overlap), the
decode of window i+1 is dispatched before window i's result is fetched
when the board already holds i+1, and the probabilities are folded into a
rolling N-window average, the streaming form of the reference's 10-trial
snapshot. Each window's latency runs from the window being complete on
the host to its probabilities being ready there.

On the card one CUDA stream carries every window in order, so a plain
device-to-host copy of window i made after window i+1 was dispatched would
wait for i+1's whole decode. Instead, the dispatch of window i enqueues a
non-blocking copy of its probabilities into pinned host memory right
behind its kernels and records a CUDA event after it; fetching i waits on
that event only (`StreamStats.fetch_wait` times the wait). The window
itself goes up from pinned memory without blocking the host either. On
the CPU the same path runs synchronously.

Two differences from the JAX loop. When the next window is ready but
window i's event has already fired (the card is idle: an eager decode
such as the LSTM's is bound by the host's launches, so the card finishes
each window as its last kernel is enqueued), i is fetched first: waiting
for the enqueue of window i+1 would add a whole host-bound decode to i's
latency and overlap nothing. Only while the card is still busy with i is
i+1 dispatched first. And no window past the n-th is dispatched, so the
engine's stats count exactly the returned predictions.

CLI: python -m neural_speech_decoding_tpu_torch.runtime.stream
    [--board replay:<dir>] [--model ckpt.npz --family lstm] [--device cpu]
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.runtime.board import Board, open_board
from neural_speech_decoding_tpu_torch.utils.timing import LatencyStats


@dataclass
class StreamPrediction:
    index: int
    probs: np.ndarray  # this window's probabilities
    avg_probs: np.ndarray  # rolling average over the last N windows
    label: str
    t_window: float  # wall time the window was complete on the host
    t_ready: float  # wall time the probabilities were available
    counter: int  # board sample counter at window end


@dataclass
class StreamStats:
    latency: LatencyStats = field(
        default_factory=lambda: LatencyStats(name="window_to_prediction")
    )
    # host time spent waiting for a window's probabilities when fetching it
    fetch_wait: LatencyStats = field(default_factory=lambda: LatencyStats(name="fetch_wait"))
    windows: int = 0
    wall_seconds: float = 0.0

    @property
    def windows_per_second(self) -> float:
        return self.windows / self.wall_seconds if self.wall_seconds else 0.0


class StreamDecoder:
    def __init__(
        self,
        engine,
        board_or_spec,
        window_seconds: float = 5.0,
        hop_seconds: float = 1.0,
        average_n: int = 10,
    ):
        """`engine`: an InferenceEngine or EnsembleEngine (its `device`
        places the decode). `board_or_spec`: a spec string or path opens a
        board; anything else is used as the board (duck-typed adapters
        included)."""
        self.engine = engine
        self.board: Board = (
            open_board(str(board_or_spec))
            if isinstance(board_or_spec, (str, os.PathLike))
            else board_or_spec
        )
        self.window_seconds = float(window_seconds)
        self.hop_seconds = float(hop_seconds)
        self.average_n = int(average_n)

    # -- one window's trip to the engine and back --------------------------
    def _dispatch(self, window_tc: np.ndarray):
        """Enqueue one [T, C] window's decode; returns what `_collect`
        needs to read its probabilities."""
        device = self.engine.device
        x = torch.from_numpy(window_tc[None])
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        return self._stage(self.engine.predict_batch_async(x))

    def _stage(self, probs: torch.Tensor):
        """Start the probabilities' copy to the host right behind the
        window's kernels; (host tensor, event or None)."""
        if probs.device.type != "cuda":
            return probs, None
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(probs.device))
        return host, event

    def _ready(self, staged) -> bool:
        """Whether a staged window's probabilities are on the host."""
        event = staged[1]
        return event is None or event.query()

    def _collect(self, staged) -> np.ndarray:
        host, event = staged
        if event is not None:
            event.synchronize()
        return host.numpy()

    # -- the loop ----------------------------------------------------------
    def run(
        self,
        n_predictions: int,
        on_prediction: Optional[Callable[[StreamPrediction], None]] = None,
        timeout: float = 300.0,
        warm: bool = True,
    ) -> tuple[List[StreamPrediction], StreamStats]:
        """Stream until `n_predictions` sliding windows are decoded, or
        `timeout` seconds have passed (then with fewer)."""
        board = self.board
        owns_session = not board._streaming
        if owns_session:
            board.prepare_session()
            board.start_stream()
        try:
            return self._run(n_predictions, on_prediction, timeout, warm)
        finally:
            if owns_session:
                board.stop_stream()
                board.release_session()

    def _run(self, n_predictions, on_prediction, timeout, warm):
        board = self.board
        fs = board.get_sampling_rate(board.get_board_id())
        n = max(1, int(self.window_seconds * fs))
        hop = max(1, int(self.hop_seconds * fs))
        speed = getattr(board, "speed", 1.0)

        if warm:
            self.engine.warmup([1])

        stats = StreamStats()
        preds: List[StreamPrediction] = []
        history: "collections.deque" = collections.deque(maxlen=self.average_n)
        pending = None  # (staged, index, t_window, counter)
        next_counter = None
        deadline = time.time() + timeout
        t_start = time.perf_counter()
        index = 0

        def finish(p):
            staged, idx, t_window, counter = p
            t_wait = time.perf_counter()
            probs = self._collect(staged)[0]
            stats.fetch_wait.record(time.perf_counter() - t_wait)
            t_ready = time.time()
            history.append(probs)
            avg = np.mean(np.stack(history), axis=0)
            pred = StreamPrediction(
                index=idx,
                probs=probs.astype(np.float32),
                avg_probs=avg.astype(np.float32),
                label=self.engine.class_names[int(np.argmax(probs))],
                t_window=t_window,
                t_ready=t_ready,
                counter=counter,
            )
            stats.latency.record(t_ready - t_window)
            stats.windows += 1
            preds.append(pred)
            if on_prediction is not None:
                on_prediction(pred)

        while len(preds) < n_predictions and time.time() < deadline:
            data = board.get_current_board_data(n)
            if data.shape[1] < n:
                time.sleep(0.005)
                continue
            counter = int(data[0, -1])
            if next_counter is not None and counter < next_counter:
                # wait for the next hop's worth of fresh samples; fetch the
                # pending result in the meantime instead of spinning
                if pending is not None:
                    finish(pending)
                    pending = None
                time.sleep(min(0.005, self.hop_seconds / (10 * speed)))
                continue
            if pending is not None and len(preds) + 1 >= n_predictions:
                finish(pending)  # the last window asked for: dispatch no more
                pending = None
                continue
            next_counter = counter + hop

            window = np.ascontiguousarray(data[board.eeg_channels, :].T, dtype=np.float32)
            t_window = time.time()
            if pending is not None and self._ready(pending[0]):
                finish(pending)  # the card is idle: nothing to overlap
                pending = None
            # pipelined: dispatch this window, then fetch the previous one
            staged = self._dispatch(window)
            if pending is not None:
                finish(pending)
            pending = (staged, index, t_window, counter)
            index += 1

        if pending is not None and len(preds) < n_predictions:
            finish(pending)
        stats.wall_seconds = time.perf_counter() - t_start
        return preds, stats


def main(argv=None) -> None:
    import argparse

    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.tester import default_model_path

    ap = argparse.ArgumentParser(description="Continuous streaming decode (PyTorch port)")
    ap.add_argument("--board", default="replay",
                    help="board spec (replay[:path], synthetic, native-*, serial:<dev>, brainflow:<port>)")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--predictions", type=int, default=20)
    ap.add_argument("--window-seconds", type=float, default=5.0)
    ap.add_argument("--hop-seconds", type=float, default=1.0)
    ap.add_argument("--average-n", type=int, default=10)
    ap.add_argument("--model", default=None, help="checkpoint (.npz, or .pth for the LSTM)")
    ap.add_argument("--family", default="lstm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    engine = InferenceEngine(
        args.model or default_model_path(), model=args.family,
        class_names=("Food", "Water", "None") if args.family == "lstm" else None,
        device=args.device,
    )
    board = open_board(args.board, speed=args.speed)
    dec = StreamDecoder(
        engine, board, window_seconds=args.window_seconds,
        hop_seconds=args.hop_seconds, average_n=args.average_n,
    )
    preds, stats = dec.run(
        args.predictions,
        on_prediction=lambda p: print(
            f"[{p.index:03d}] {p.label:8s} probs={np.round(p.probs, 3)} "
            f"avg={np.round(p.avg_probs, 3)} "
            f"latency={(p.t_ready - p.t_window) * 1e3:.1f}ms",
            flush=True,
        ),
    )
    print(f"\n{stats.windows} windows, {stats.windows_per_second:.2f}/s, {stats.latency}")


if __name__ == "__main__":
    main()
