"""Optional BrainFlow-backed board for real Knight hardware.

Own copy of neural_speech_decoding_tpu/runtime/brainflow_board.py.
The reference's only physical input device speaks BrainFlow's proprietary
binary serial protocol through the C++ BoardShim (reference:
neurokit_connector.py:16, knight_board_init.py:14). That protocol is not
re-implementable here (undocumented, firmware-specific), so real-hardware
acquisition is adapter-based: wherever the `brainflow` package is
installed, `open_board("brainflow:<port>")` returns a thin mapping of
BoardShim onto the exact `Board` sub-surface the rest of the runtime uses
(runtime/board.py docstring); everywhere else it raises an actionable
ImportError and the replay/synthetic/native/serial boards cover testing.

No import of this module happens unless a brainflow: spec is requested, so
the dependency stays fully optional.
"""

from __future__ import annotations

from typing import List, Optional


class BrainFlowBoard:
    """BoardShim -> Board adapter (duck-typed; see runtime/board.py)."""

    #: BrainFlow's id for the Neuropawn Knight (the reference's device).
    NEUROPAWN_KNIGHT = 57

    def __init__(self, serial_port: str, board_id: Optional[int] = None):
        try:
            from brainflow.board_shim import (
                BoardIds,
                BoardShim,
                BrainFlowInputParams,
            )
        except ImportError as e:
            raise ImportError(
                "board spec 'brainflow:<port>' needs the brainflow package, "
                "which is not installed in this environment; use "
                "'replay[:path]', 'synthetic', or 'serial:<device>' instead"
            ) from e

        if board_id is None:
            board_id = getattr(
                BoardIds, "NEUROPAWN_KNIGHT_BOARD", self.NEUROPAWN_KNIGHT
            )
            board_id = int(board_id)
        params = BrainFlowInputParams()
        params.serial_port = serial_port
        self._shim_cls = BoardShim
        self._board_id = int(board_id)
        self._shim = BoardShim(self._board_id, params)
        # part of the runtime Board surface: StreamDecoder and the
        # session-ownership logic read it
        self._streaming = False

    # -- Board surface ----------------------------------------------------
    def get_board_id(self) -> int:
        return self._board_id

    def get_sampling_rate(self, board_id: Optional[int] = None) -> int:
        return int(
            self._shim_cls.get_sampling_rate(
                self._board_id if board_id is None else board_id
            )
        )

    def get_exg_channels(self, board_id: Optional[int] = None) -> List[int]:
        return list(
            self._shim_cls.get_exg_channels(
                self._board_id if board_id is None else board_id
            )
        )

    def prepare_session(self) -> None:
        self._shim.prepare_session()

    def config_board(self, cmd: str):
        return self._shim.config_board(cmd)

    def config_board_with_bytes(self, payload: bytes) -> None:
        self._shim.config_board_with_bytes(payload)

    def start_stream(self, buffer_size: int = 450000) -> None:
        self._shim.start_stream(buffer_size)
        self._streaming = True

    def stop_stream(self) -> None:
        self._shim.stop_stream()
        self._streaming = False

    def release_session(self) -> None:
        self._shim.release_session()

    def get_board_data_count(self) -> int:
        return int(self._shim.get_board_data_count())

    def get_current_board_data(self, n: int):
        return self._shim.get_current_board_data(n)

    @property
    def eeg_channels(self) -> List[int]:
        return self.get_exg_channels()
