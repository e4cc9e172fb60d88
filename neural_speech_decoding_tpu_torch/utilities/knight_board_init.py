"""`utilities.knight_board_init`: the reference's `KnightBoard`.

The legacy connector of the collector path (reference:
knight_board_init.py:6-41): it configures the channels *after*
`start_stream` (runtime/connector.Connector configures before), with
plain config commands, over the port's board helpers.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from neural_speech_decoding_tpu_torch.runtime.board import (
    open_board,
    read_channel_window,
    send_board_command,
)


class KnightBoard:
    def __init__(self, serial_port, num_channels: int = 8, buffer_size: int = 450000):
        self.board = (
            open_board(str(serial_port), num_channels=num_channels)
            if isinstance(serial_port, (str, os.PathLike))
            else serial_port
        )
        self.board_shim = self.board  # the collector reaches through this
        self.num_channels = int(num_channels)
        self.buffer_size = int(buffer_size)
        self.board_id = self.board.get_board_id()
        self.eeg_channels: List[int] = self.board.get_exg_channels(self.board_id)
        if len(self.eeg_channels) > self.num_channels:
            self.eeg_channels = self.eeg_channels[: self.num_channels]
        self.sr: int = self.board.get_sampling_rate(self.board_id)
        self._streaming = False

    def start_stream(self) -> None:
        # legacy order: stream first, then each channel's config
        self.board.prepare_session()
        self.board.start_stream(self.buffer_size)
        for x in range(1, self.num_channels + 1):
            send_board_command(self.board, f"chon_{x}_12")
            send_board_command(self.board, f"rldadd_{x}")
        self._streaming = True

    def stop_stream(self) -> None:
        if self._streaming:
            self.board.stop_stream()
            self.board.release_session()
            self._streaming = False

    def get_window(self, seconds: float) -> np.ndarray:
        if not self._streaming:
            raise RuntimeError("get_window() before start_stream()")
        return read_channel_window(self.board, self.eeg_channels, seconds, self.sr)
