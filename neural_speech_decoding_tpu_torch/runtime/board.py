"""EEG acquisition boards.

Own copy of neural_speech_decoding_tpu/runtime/board.py (the port imports
nothing of the JAX package). Boards expose the BrainFlow BoardShim
sub-surface the runtime uses:

  prepare_session / start_stream / stop_stream / release_session
  get_board_data_count / get_current_board_data / config_board(_with_bytes)

`get_current_board_data(n)` returns [rows, n] with a sample counter in row
0 and the EEG channels at the `eeg_channels` row indices. Two engines
provide the samples: a pure-Python producer thread over a ring buffer
(`SyntheticBoard`, `ReplayBoard`), and the C++ runtime of native/ behind
ctypes (`NativeBoard`, built by runtime/native.py). `ReplayBoard` streams
recorded trials (an array, a .npy file, or a directory of trial CSVs) in a
loop; `SyntheticBoard` generates per-channel sin + modulation + noise. A
`speed` multiplier lets tests run faster than real time while keeping
real-time semantics at speed=1. `open_board` resolves every spec of the
JAX package's `open_board`, the serial and BrainFlow boards included
(runtime/serial_board.py, runtime/brainflow_board.py).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from neural_speech_decoding_tpu_torch.runtime import native


class RingBuffer:
    """Thread-safe ring buffer of multi-channel samples ([rows] per tick)."""

    def __init__(self, rows: int, capacity: int):
        self.rows = rows
        self.capacity = int(capacity)
        self._buf = np.zeros((rows, self.capacity), dtype=np.float64)
        self._write = 0  # total samples ever written
        self._lock = threading.Lock()

    def push(self, block: np.ndarray) -> None:
        """block: [rows, k]"""
        k = block.shape[1]
        with self._lock:
            pos = self._write % self.capacity
            end = pos + k
            if end <= self.capacity:
                self._buf[:, pos:end] = block
            else:
                first = self.capacity - pos
                self._buf[:, pos:] = block[:, :first]
                self._buf[:, : end - self.capacity] = block[:, first:]
            self._write += k

    def count(self) -> int:
        with self._lock:
            return min(self._write, self.capacity)

    def latest(self, n: int) -> np.ndarray:
        """Most recent min(n, available) samples, oldest first: [rows, m]."""
        with self._lock:
            avail = min(self._write, self.capacity)
            m = min(n, avail)
            if m == 0:
                return np.empty((self.rows, 0), dtype=np.float64)
            end = self._write % self.capacity
            start = (end - m) % self.capacity
            if start < end or end == 0:
                sl = self._buf[:, start : start + m]
                return np.array(sl, copy=True)
            return np.concatenate(
                [self._buf[:, start:], self._buf[:, :end]], axis=1
            )


class Board:
    """Base board: BoardShim-compatible sub-surface over a sample engine."""

    def __init__(
        self,
        num_channels: int = 8,
        sample_rate: int = 125,
        num_rows: Optional[int] = None,
        speed: float = 1.0,
    ):
        self.num_channels = int(num_channels)
        self.sr = int(sample_rate)
        # BrainFlow boards carry extra rows (counter, timestamps...); we
        # model one counter row + channels so channel indexing is exercised.
        self.num_rows = num_rows or (self.num_channels + 1)
        self.eeg_channels: List[int] = list(range(1, self.num_channels + 1))
        self.speed = float(speed)
        self._prepared = False
        self._streaming = False
        self._ring: Optional[RingBuffer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sent = 0
        self.config_log: List[str] = []

    # -- BoardShim surface ---------------------------------------------
    def get_board_id(self) -> int:
        return -1  # playback/synthetic

    def get_sampling_rate(self, board_id: int = -1) -> int:
        return self.sr

    def get_exg_channels(self, board_id: int = -1) -> List[int]:
        return list(self.eeg_channels)

    def prepare_session(self) -> None:
        self._prepared = True

    def config_board(self, cmd: str) -> str:
        self.config_log.append(cmd)
        return "ok"

    def config_board_with_bytes(self, payload: bytes) -> None:
        self.config_log.append(payload.decode("ascii", errors="replace"))

    def start_stream(self, buffer_size: int = 450000) -> None:
        if not self._prepared:
            raise RuntimeError("prepare_session() not called")
        self._ring = RingBuffer(self.num_rows, buffer_size)
        self._stop.clear()
        self._sent = 0
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._streaming = True
        self._thread.start()

    def stop_stream(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._streaming = False

    def release_session(self) -> None:
        if self._streaming:
            self.stop_stream()
        self._prepared = False

    def get_board_data_count(self) -> int:
        return self._ring.count() if self._ring is not None else 0

    def get_current_board_data(self, n: int) -> np.ndarray:
        if self._ring is None:
            return np.empty((self.num_rows, 0), dtype=np.float64)
        return self._ring.latest(n)

    # -- producer thread -------------------------------------------------
    def _pump(self) -> None:
        """Emit samples at sr * speed in small blocks."""
        block = max(1, self.sr // 25)  # ~40 ms of data per push at speed=1
        period = block / (self.sr * self.speed)
        next_t = time.perf_counter()
        while not self._stop.is_set():
            data = self._generate(self._sent, block)  # [rows, block]
            self._ring.push(data)
            self._sent += block
            next_t += period
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.perf_counter()  # fell behind; don't burst

    def _generate(self, start: int, k: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class SyntheticBoard(Board):
    """Per-channel sin + slow modulation + Gaussian noise, like the
    frontend mock generator (reference: Frontend/app.py:58-66)."""

    def __init__(self, num_channels: int = 8, sample_rate: int = 125, speed: float = 1.0, seed: int = 0):
        super().__init__(num_channels, sample_rate, speed=speed)
        self._rng = np.random.default_rng(seed)

    def _generate(self, start: int, k: int) -> np.ndarray:
        t = (start + np.arange(k)) / self.sr
        out = np.zeros((self.num_rows, k), dtype=np.float64)
        out[0] = start + np.arange(k)  # counter row
        for ch in range(self.num_channels):
            base = np.sin(2 * np.pi * (8 + ch) * t)
            mod = 0.4 * np.sin(2 * np.pi * (2 + ch * 0.2) * t + ch)
            noise = 0.35 * self._rng.standard_normal(k)
            out[1 + ch] = base + mod + noise
        return out


class ReplayBoard(Board):
    """Streams recorded trials (an array or .npy file of [N, T, C] or
    [T, C], or a directory of `<class>_*.csv` trials) in order, looping
    forever."""

    def __init__(
        self,
        source,
        num_channels: int = 8,
        sample_rate: int = 125,
        speed: float = 1.0,
        loop: bool = True,
    ):
        super().__init__(num_channels, sample_rate, speed=speed)
        self.loop = loop
        self._data = self._load(source)  # [C, total_T]

    def _load(self, source) -> np.ndarray:
        if isinstance(source, np.ndarray):
            arr = source
        else:
            path = Path(source)
            if path.suffix == ".npy":
                arr = np.load(path, allow_pickle=False)
            else:
                arr = _trial_stream(path)
        if arr.ndim == 3:  # [N, T, C] stack of windows
            arr = np.concatenate(list(arr), axis=0)
        if arr.ndim != 2:
            raise ValueError(f"replay source must be 2D/3D, got {arr.shape}")
        # [T, C] -> [C, T]
        return np.ascontiguousarray(arr.T, dtype=np.float64)

    def _generate(self, start: int, k: int) -> np.ndarray:
        total = self._data.shape[1]
        idx = (start + np.arange(k)) % total if self.loop else np.clip(
            start + np.arange(k), 0, total - 1
        )
        out = np.zeros((self.num_rows, k), dtype=np.float64)
        out[0] = start + np.arange(k)
        out[1 : 1 + self.num_channels] = self._data[: self.num_channels, idx]
        return out


def _trial_stream(data_dir) -> np.ndarray:
    """The recorded trials under `data_dir` back to back, [T_total, C]."""
    from neural_speech_decoding_tpu_torch.io.dataset import load_trials

    ds = load_trials(data_dir, strict_shape=False)
    return np.concatenate(list(ds.windows), axis=0)


class NativeBoard(Board):
    """Board whose ring buffer and producer thread live in the C++ runtime
    (native/nsd_board.cpp), bound through ctypes: the same surface, no
    Python in the sample path. The library is built at the first
    NativeBoard; a failed build raises."""

    def __init__(
        self,
        mode: str,
        num_channels: int = 8,
        sample_rate: int = 125,
        speed: float = 1.0,
        replay_data: Optional[np.ndarray] = None,  # [C, T]
        seed: int = 0,
    ):
        super().__init__(num_channels, sample_rate, speed=speed)
        if mode == "replay" and replay_data is None:
            raise ValueError("replay mode needs replay_data [C, T]")
        self._native = native.NativeBoardHandle(
            native.load_library(),
            mode=mode,
            num_rows=self.num_rows,
            num_channels=num_channels,
            sample_rate=sample_rate,
            seed=seed,
        )
        if mode == "replay":
            self._native.load_replay(np.ascontiguousarray(replay_data, dtype=np.float32))

    def start_stream(self, buffer_size: int = 450000) -> None:
        if not self._prepared:
            raise RuntimeError("prepare_session() not called")
        self._native.start(buffer_size, self.speed)
        self._streaming = True

    def stop_stream(self) -> None:
        self._native.stop()
        self._streaming = False

    def release_session(self) -> None:
        if self._streaming:
            self.stop_stream()
        self._native.release()
        self._prepared = False

    def get_board_data_count(self) -> int:
        return self._native.data_count()

    def get_current_board_data(self, n: int) -> np.ndarray:
        return self._native.get_current(n)


def send_board_command(board, command: str) -> bool:
    """Deliver one channel-config command over whichever config transport
    the board offers, bytes-first (some firmwares reply with undecodable
    bytes, which the string API chokes on). Returns True once a transport
    accepts the command; False when every transport rejected it — callers
    treat an unconfigurable board as best-effort, matching the reference's
    tolerance for boards that ignore config writes.
    """
    transports = (
        lambda: board.config_board_with_bytes(command.encode("ascii")),
        lambda: board.config_board(command),
    )
    for send in transports:
        try:
            send()
        except Exception:
            continue
        return True
    return False


def read_channel_window(board, channel_rows, seconds: float, sample_rate: int) -> np.ndarray:
    """Most recent `seconds` of the given channel rows, as [C, T] oldest
    first. T may be shorter than requested (down to zero) right after
    stream start, before the ring buffer has filled — callers poll
    `get_board_data_count` when they need a full window.
    """
    want = round(seconds * sample_rate)
    raw = board.get_current_board_data(want if want >= 1 else 1)
    return raw[list(channel_rows), :]


def _default_replay_dir():
    from neural_speech_decoding_tpu_torch.io.dataset import default_data_dir

    src = default_data_dir()
    if src is None:
        raise FileNotFoundError(
            "replay board: no source path and no default dataset (set $NSD_DATA_DIR)"
        )
    return src


def open_board(spec: str, num_channels: int = 8, speed: float = 1.0) -> Board:
    """Resolve a board spec string to a Board.

    Specs:
      "synthetic"              pure-Python synthetic board
      "replay:<dir-or-.npy>"   replay recorded trials from a path
      "replay"                 replay the $NSD_DATA_DIR trials
      "native-synthetic"       C++ engine synthetic board
      "native-replay[:path]"   C++ engine replay of a trial directory
                               ($NSD_DATA_DIR without a path)
      "serial:<device>"        live text-frame acquisition from a serial
                               character device (runtime/serial_board.py)
      "brainflow:<port>[:id]"  real Knight hardware through the BrainFlow
                               BoardShim, where brainflow is installed
                               (runtime/brainflow_board.py, import-gated)
      anything else            treated as an unadapted hardware port
    """
    if spec == "synthetic":
        return SyntheticBoard(num_channels=num_channels, speed=speed)
    if spec == "replay" or spec.startswith("replay:"):
        src = spec.split(":", 1)[1] if ":" in spec else _default_replay_dir()
        return ReplayBoard(src, num_channels=num_channels, speed=speed)
    if spec == "native-synthetic":
        return NativeBoard("synthetic", num_channels=num_channels, speed=speed)
    if spec == "native-replay" or spec.startswith("native-replay:"):
        src = spec.split(":", 1)[1] if ":" in spec else _default_replay_dir()
        return NativeBoard(
            "replay",
            num_channels=num_channels,
            speed=speed,
            replay_data=_trial_stream(src).T,  # [C, T]
        )
    if spec.startswith("serial:"):
        from neural_speech_decoding_tpu_torch.runtime.serial_board import SerialBoard

        return SerialBoard(spec.split(":", 1)[1], num_channels=num_channels)
    if spec.startswith("brainflow:"):
        from neural_speech_decoding_tpu_torch.runtime.brainflow_board import BrainFlowBoard

        port, _, board_id = spec.split(":", 1)[1].partition(":")
        return BrainFlowBoard(port, int(board_id) if board_id else None)
    raise RuntimeError(
        f"board spec {spec!r} looks like a hardware serial port; the "
        "BrainFlow binary protocol is not re-implementable here — use "
        "'brainflow:<port>' where the brainflow package is installed, "
        "'serial:<device>' for text-frame devices, or 'replay[:path]' / "
        "'synthetic'"
    )
