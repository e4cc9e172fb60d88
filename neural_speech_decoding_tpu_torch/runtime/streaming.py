"""Streaming producer — the L1 equivalent of the reference's StreamingProcess.

Own copy of neural_speech_decoding_tpu/runtime/streaming.py. Behavioral
spec (reference: streaming_process.py:31-72): while a recording
flag is set, wait until a full window of samples is buffered, rate-limit to
one emission per window, then emit `{"sr", "channels", "data" [T,C] f32,
"t_emit"}`; on a full queue drop the oldest payload and retry.

The producer is a *thread*, not a process: the consumer hands windows
straight to the inference engine, so a second interpreter buys nothing but
IPC copies.
The bounded drop-oldest queue and flag/stop semantics are preserved exactly
(they are the backpressure contract the tester relies on). The rate limit
scales with the board's `speed` so accelerated replay keeps one-emission-
per-window semantics in *board time*.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from neural_speech_decoding_tpu_torch.runtime.connector import Connector


class _Flag:
    """Mutable boolean with the `.value` shape of multiprocessing.Value
    (keeps the reference's `producer.recording_flag.value = True` idiom)."""

    def __init__(self, initial: bool = False):
        self._event = threading.Event()
        if initial:
            self._event.set()

    @property
    def value(self) -> bool:
        return self._event.is_set()

    @value.setter
    def value(self, v: bool) -> None:
        if v:
            self._event.set()
        else:
            self._event.clear()


class StreamingProducer(threading.Thread):
    def __init__(
        self,
        board_or_spec,
        num_channels: int = 8,
        window_seconds: float = 5.0,
        out_queue: Optional["queue.Queue"] = None,
        start_recording: bool = False,
        buffer_size: int = 450000,
        max_queue: int = 8,
    ):
        super().__init__(daemon=True)
        self.board_or_spec = board_or_spec
        self.num_channels = int(num_channels)
        self.window_seconds = float(window_seconds)
        self.buffer_size = int(buffer_size)
        self.out_queue: "queue.Queue" = out_queue or queue.Queue(maxsize=max_queue)
        self.recording_flag = _Flag(start_recording)
        self._running = threading.Event()
        self._running.set()
        self._error: Optional[BaseException] = None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # surfaced through is_alive()/error
            self._error = e

    def _run(self) -> None:
        conn = Connector(
            self.board_or_spec,
            num_channels=self.num_channels,
            buffer_size=self.buffer_size,
        )
        conn.start_stream()
        try:
            sr = conn.sr
            samples_per_win = max(1, int(self.window_seconds * sr))
            speed = getattr(conn.board, "speed", 1.0)
            emit_period = self.window_seconds / speed  # board-time window
            last_emit = 0.0

            while self._running.is_set():
                if not self.recording_flag.value:
                    time.sleep(0.01)
                    continue

                # wait for a full window in the ring buffer
                while (
                    self._running.is_set()
                    and conn.board.get_board_data_count() < samples_per_win
                ):
                    time.sleep(0.002)
                if not self._running.is_set():
                    break

                now = time.time()
                if now - last_emit < emit_period:
                    time.sleep(min(0.01, emit_period / 10))
                    continue

                eeg = conn.get_window(self.window_seconds)  # [C, T]
                if eeg.shape[1] >= samples_per_win and eeg.shape[0] > 0:
                    chunk = np.ascontiguousarray(eeg.T, dtype=np.float32)
                    payload = {
                        "sr": sr,
                        "channels": conn.eeg_channels,
                        "data": chunk,
                        "t_emit": now,
                    }
                    try:
                        self.out_queue.put_nowait(payload)
                        last_emit = now
                    except queue.Full:
                        # drop-oldest backpressure (reference:
                        # streaming_process.py:63-69)
                        try:
                            self.out_queue.get_nowait()
                            self.out_queue.put_nowait(payload)
                            last_emit = now
                        except (queue.Empty, queue.Full):
                            pass
                time.sleep(0.002)
        finally:
            conn.stop_stream()

    def stop(self) -> None:
        self._running.clear()
