"""Serial-device board: live acquisition from a character device.

Own copy of neural_speech_decoding_tpu/runtime/serial_board.py.
The reference's hardware path is BrainFlow's proprietary Neuropawn Knight
serial protocol (reference: neurokit_connector.py:16). That binary protocol
is not publicly documented, so this board implements the common
hobby-BCI text framing instead — one sample per line, comma/space-separated
channel values — which covers devices/firmware that stream CSV frames and
doubles as a bridge: anything that can be adapted to emit text frames
(including a BrainFlow-to-stdout shim on a machine that has BrainFlow)
feeds this framework live.

No pyserial dependency: the device is opened as a raw file descriptor
(works for /dev/tty*, PTYs, FIFOs). Baud/termios setup is applied when the
fd is a tty and the `termios` module is available. Config commands write
`<cmd>\\n` to the device (the reference's `chon_x_12` strings go through
unchanged).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from neural_speech_decoding_tpu_torch.runtime.board import Board


class SerialBoard(Board):
    def __init__(
        self,
        device_path: str,
        num_channels: int = 8,
        sample_rate: int = 125,
        baudrate: int = 115200,
    ):
        super().__init__(num_channels, sample_rate, speed=1.0)
        self.device_path = device_path
        self.baudrate = baudrate
        self._fd: Optional[int] = None

    # -- session ----------------------------------------------------------
    def prepare_session(self) -> None:
        self._fd = os.open(self.device_path, os.O_RDWR | os.O_NOCTTY)
        if os.isatty(self._fd):
            try:
                import termios

                attrs = termios.tcgetattr(self._fd)
                baud = getattr(termios, f"B{self.baudrate}", termios.B115200)
                attrs[2] = (attrs[2] & ~termios.CSIZE) | termios.CS8
                attrs[4] = baud
                attrs[5] = baud
                # raw mode
                attrs[3] &= ~(termios.ICANON | termios.ECHO)
                termios.tcsetattr(self._fd, termios.TCSANOW, attrs)
            except Exception:
                pass  # non-fatal: PTYs/FIFOs don't need termios
        self._prepared = True

    def config_board(self, cmd: str) -> str:
        self.config_log.append(cmd)
        if self._fd is not None:
            os.write(self._fd, (cmd + "\n").encode("ascii", errors="replace"))
        return "ok"

    def config_board_with_bytes(self, payload: bytes) -> None:
        self.config_log.append(payload.decode("ascii", errors="replace"))
        if self._fd is not None:
            os.write(self._fd, payload + b"\n")

    def release_session(self) -> None:
        super().release_session()
        if self._fd is not None:
            try:
                os.close(self._fd)
            finally:
                self._fd = None

    # -- producer: read + parse text frames -------------------------------
    def _pump(self) -> None:
        if self._fd is None:
            raise RuntimeError("prepare_session() not called")
        buf = b""
        count = 0
        while not self._stop.is_set():
            try:
                chunk = os.read(self._fd, 4096)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            *lines, buf = buf.split(b"\n")
            samples: List[np.ndarray] = []
            for line in lines:
                vals = self._parse_line(line)
                if vals is not None:
                    row = np.zeros(self.num_rows)
                    row[0] = count
                    row[1 : 1 + self.num_channels] = vals
                    samples.append(row)
                    count += 1
            if samples:
                self._ring.push(np.stack(samples, axis=1))

    def _parse_line(self, line: bytes) -> Optional[np.ndarray]:
        text = line.strip().decode("ascii", errors="replace")
        if not text or text[0].isalpha():  # echo/status lines
            return None
        parts = text.replace(",", " ").split()
        try:
            vals = np.array([float(p) for p in parts], dtype=np.float64)
        except ValueError:
            return None
        if vals.size < self.num_channels:
            return None
        return vals[: self.num_channels]
