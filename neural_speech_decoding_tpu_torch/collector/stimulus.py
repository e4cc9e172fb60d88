"""Stimulus presentation for the collection experiment.

Own copy of neural_speech_decoding_tpu/collector/stimulus.py.
The reference runs a timed audiovisual protocol through PsychoPy: beep
0-0.5 s, the cue word on screen 0.5-4.5 s, "COOL OFF" 4.5-6 s, with an
escape-key abort path and experiment logging (reference:
Neural_decoding_data_collector.py:543-681 frame loop, :557-580 beep,
:585-616 word, :621-650 cool-off; abort handling :683-693). The headless
experiment (collector/experiment.py) reproduces the data-producing
schedule; this module adds the subject-facing side so a human can actually
sit a session without PsychoPy: a terminal presenter (ANSI word display +
bell beep + ESC/q abort from cbreak stdin) behind a small Presenter
protocol that any GUI could implement.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional, TextIO


class AbortRequested(Exception):
    """Raised inside the schedule when the subject aborts (reference:
    escape ends the experiment and keeps the data collected so far)."""


class Presenter:
    """Stimulus surface. Implementations must be cheap per call — timing
    lives in the experiment schedule, not here."""

    def beep(self) -> None:  # pragma: no cover - interface
        pass

    def show_word(self, word: str) -> None:  # pragma: no cover - interface
        pass

    def cool_off(self) -> None:  # pragma: no cover - interface
        pass

    def status(self, text: str) -> None:  # pragma: no cover - interface
        pass

    def aborted(self) -> bool:
        return False

    def close(self) -> None:  # pragma: no cover - interface
        pass


class TerminalPresenter(Presenter):
    """ANSI-terminal presenter: clears the screen, centers the cue word,
    beeps with the terminal bell, and aborts on ESC or q.

    The keyboard listener uses cbreak mode on a real TTY; when stdin is not
    a TTY (tests, pipes) the listener is skipped and `request_abort()` /
    an injected event provide the same control path.
    """

    def __init__(
        self,
        out: Optional[TextIO] = None,
        bell: bool = True,
        listen_keys: Optional[bool] = None,
        width: int = 60,
    ):
        self.out = out if out is not None else sys.stdout
        self.bell = bell
        self.width = width
        self._abort = threading.Event()
        self._stop_listener = threading.Event()
        self._listener: Optional[threading.Thread] = None
        if listen_keys is None:
            listen_keys = sys.stdin.isatty()
        if listen_keys:
            self._listener = threading.Thread(target=self._listen, daemon=True)
            self._listener.start()

    # -- keyboard ---------------------------------------------------------
    def _listen(self) -> None:  # pragma: no cover - needs a real TTY
        import select
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._stop_listener.is_set():
                ready, _, _ = select.select([fd], [], [], 0.1)
                if ready:
                    ch = sys.stdin.read(1)
                    if ch in ("\x1b", "q", "Q"):
                        self._abort.set()
                        return
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def request_abort(self) -> None:
        self._abort.set()

    def aborted(self) -> bool:
        return self._abort.is_set()

    # -- display ----------------------------------------------------------
    def _screen(self, *lines: str) -> None:
        self.out.write("\x1b[2J\x1b[H\n\n")
        for line in lines:
            self.out.write(line.center(self.width) + "\n")
        self.out.write("\n" + "(ESC or q to abort)".center(self.width) + "\n")
        self.out.flush()

    def beep(self) -> None:
        if self.bell:
            self.out.write("\a")
        self._screen("*", "(get ready)")

    def show_word(self, word: str) -> None:
        self._screen("+" + "-" * (len(word) + 6) + "+",
                     "|   " + word.upper() + "   |",
                     "+" + "-" * (len(word) + 6) + "+",
                     "",
                     "imagine saying the word")

    def cool_off(self) -> None:
        self._screen("COOL OFF")

    def status(self, text: str) -> None:
        self.out.write(text.center(self.width) + "\n")
        self.out.flush()

    def close(self) -> None:
        """Stop the key listener (restoring the terminal mode). Leaves the
        screen contents alone so the final status / session summary stays
        visible after the program exits."""
        self._stop_listener.set()
        if self._listener is not None:
            self._listener.join(timeout=1.0)
        self.out.write("\n")
        self.out.flush()
