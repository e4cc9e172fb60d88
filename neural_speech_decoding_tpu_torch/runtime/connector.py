"""Device connector — the L0 equivalent of the reference's NeuroPawnConnector.

Own copy of neural_speech_decoding_tpu/runtime/connector.py.

Behavioral spec (reference: neurokit_connector.py:10-67): open a session,
truncate the EXG channel list to `num_channels`, send per-channel enable +
reference-electrode config commands (`chon_{x}_12`, `rldadd_{x}`) before
starting the stream, then serve ring-buffer window reads as [C, T].

Differences by design: the board is injected (replay/synthetic, or any
object with the BoardShim surface) instead of hard-wired to one BrainFlow
board id, and the stabilization sleeps are only applied to hardware-like boards (replay/synthetic have
nothing to stabilize, so tests run fast).
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np

from neural_speech_decoding_tpu_torch.runtime.board import (
    open_board,
    read_channel_window,
    send_board_command,
)


class Connector:
    def __init__(
        self,
        board_or_spec,
        num_channels: int = 8,
        buffer_size: int = 450000,
        configure_channels: bool = True,
        stabilize: bool = False,
    ):
        # dispatch on spec-ness, not a concrete class: board objects include
        # duck-typed adapters (e.g. BrainFlowBoard) that are not Board
        # subclasses; str and path-like values are specs
        if isinstance(board_or_spec, (str, os.PathLike)):
            self.board = open_board(str(board_or_spec), num_channels=num_channels)
        else:
            self.board = board_or_spec
        self.num_channels = int(num_channels)
        self.buffer_size = int(buffer_size)
        self.configure_channels = configure_channels
        self.stabilize = stabilize

        self.board_id = self.board.get_board_id()
        self.eeg_channels: List[int] = self.board.get_exg_channels(self.board_id)
        if len(self.eeg_channels) > self.num_channels:
            self.eeg_channels = self.eeg_channels[: self.num_channels]
        self.sr: int = self.board.get_sampling_rate(self.board_id)
        self._streaming = False

    def start_stream(self) -> None:
        self.board.prepare_session()
        if self.stabilize:
            time.sleep(0.5)
        if self.configure_channels:
            for x in range(1, self.num_channels + 1):
                send_board_command(self.board, f"chon_{x}_12")
                send_board_command(self.board, f"rldadd_{x}")
                if self.stabilize:
                    time.sleep(0.3)
        self.board.start_stream(self.buffer_size)
        self._streaming = True
        if self.stabilize:
            time.sleep(1.0)

    def stop_stream(self) -> None:
        if self._streaming:
            self.board.stop_stream()
            self.board.release_session()
            self._streaming = False

    def get_window(self, seconds: float) -> np.ndarray:
        """Latest `seconds` of EEG as [C, T] (oldest first)."""
        if not self._streaming:
            raise RuntimeError("get_window() before start_stream()")
        return read_channel_window(self.board, self.eeg_channels, seconds, self.sr)
