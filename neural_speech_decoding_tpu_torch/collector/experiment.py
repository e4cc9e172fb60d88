"""Headless data-collection experiment.

Counterpart of neural_speech_decoding_tpu/collector/experiment.py; the
filter chain of each captured trial runs on `device` (the card unless the
caller passes device="cpu", or --device cpu on the command line).
The reference's collector is a PsychoPy Builder program (reference:
Neural_decoding_data_collector.py, DataCollectionExperiment.psyexp): per
trial a 0.5 s beep, 4 s of word display (imagination), 1.5 s cool-off; the
recording flag rises as the word disappears so the captured 625 samples
span roughly beep + imagination; words come from a fullRandom TrialHandler
over {water, food, yes, no} x nReps.

This module reproduces the *data-producing* semantics headlessly (the
stimulus GUI is display-side and out of decode scope): same trial schedule,
same fullRandom word order, same rising-edge capture of the last 625
samples, same filter chain + CSV format via collector.chain. A `speed`
multiplier compresses the schedule together with an accelerated board so a
full session runs in seconds.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from neural_speech_decoding_tpu_torch.collector.chain import record_trial
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_WORDS = ("water", "food", "yes", "no")  # reference: words.csv


def load_words_csv(path) -> tuple:
    """Read a PsychoPy-style conditions file: a `words` header followed by
    one word per row (reference: words.csv via
    DataCollectionExperiment.psyexp:182)."""
    lines = [ln.strip() for ln in Path(path).read_text().splitlines() if ln.strip()]
    if not lines or lines[0].lower() != "words":
        raise ValueError(f"{path}: expected a 'words' header row")
    return tuple(lines[1:])


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    words: Sequence[str] = DEFAULT_WORDS
    n_reps: int = 10  # reference NUMBER_OF_REPS (a string "10" there)
    beep_seconds: float = 0.5
    word_seconds: float = 4.0
    cooloff_seconds: float = 1.5
    window_samples: int = 625
    warmup_seconds: float = 25.0  # reference: collector :244-249
    seed: int = 0

    @property
    def trial_seconds(self) -> float:
        return self.beep_seconds + self.word_seconds + self.cooloff_seconds


def full_random_order(config: ExperimentConfig) -> List[str]:
    """PsychoPy fullRandom: every (word, rep) pair shuffled globally."""
    rng = np.random.default_rng(config.seed)
    pool = [w for w in config.words for _ in range(config.n_reps)]
    return [pool[i] for i in rng.permutation(len(pool))]


def _phase_wait(seconds: float, presenter) -> None:
    """Sleep through one stimulus phase, polling the abort path like the
    reference's per-frame escape check (collector :683-693)."""
    if presenter is None:
        time.sleep(seconds)
        return
    from neural_speech_decoding_tpu_torch.collector.stimulus import AbortRequested

    deadline = time.perf_counter() + seconds
    while True:
        if presenter.aborted():
            raise AbortRequested
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            return
        time.sleep(min(0.05, remaining))


def run_experiment(
    board,
    out_dir,
    config: ExperimentConfig = ExperimentConfig(),
    speed: Optional[float] = None,
    on_trial: Optional[Callable[[int, str, Optional[Path]], None]] = None,
    presenter=None,
    device: DeviceLike = None,
) -> List[Path]:
    """Run a full collection session against a (started) board.

    The board must already be prepared + streaming. `speed` defaults to the
    board's own speed so schedule time and sample time stay consistent.
    With a `presenter` (collector/stimulus.py) the subject-facing protocol
    runs too — beep, cue word, COOL OFF — and an abort keeps the trials
    written so far (reference escape semantics). Each trial's filter chain
    runs on `device`. Returns the list of written CSV paths.
    """
    from neural_speech_decoding_tpu_torch.collector.stimulus import AbortRequested

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    speed = float(speed if speed is not None else getattr(board, "speed", 1.0))
    scale = 1.0 / speed

    fs = board.get_sampling_rate(board.get_board_id())
    # warm-up: let the ring buffer fill past one window. The abort key must
    # already respond here (reference checks escape every frame) — a human
    # otherwise stares at a dead "warming up" screen for up to ~35 s.
    if presenter is not None:
        presenter.status("warming up…")
    t_deadline = time.time() + max(1.0, config.warmup_seconds * scale) + 10.0
    while (
        board.get_board_data_count() < config.window_samples
        and time.time() < t_deadline
    ):
        if presenter is not None and presenter.aborted():
            presenter.status("aborted during warm-up — no trials recorded")
            return []
        time.sleep(0.01)

    paths: List[Path] = []
    order = full_random_order(config)
    try:
        for i, word in enumerate(order):
            # beep + word display: recording flag low (reference keeps the
            # flag False while the word is on screen, collector :600)
            if presenter is not None:
                presenter.beep()
            _phase_wait(config.beep_seconds * scale, presenter)
            if presenter is not None:
                presenter.show_word(word)
            _phase_wait(config.word_seconds * scale, presenter)
            # rising edge at word offset: capture last 625 samples
            path = record_trial(
                board, word, out_dir, window_samples=config.window_samples, fs=fs,
                device=device,
            )
            if path is not None:
                paths.append(path)
            if on_trial is not None:
                on_trial(i, word, path)
            if presenter is not None:
                presenter.cool_off()
            _phase_wait(config.cooloff_seconds * scale, presenter)
    except AbortRequested:
        if presenter is not None:
            presenter.status(f"aborted — kept {len(paths)} trials")
    return paths


def main(argv=None) -> None:
    import argparse

    from neural_speech_decoding_tpu_torch.runtime.board import open_board

    ap = argparse.ArgumentParser(description="Headless collection session (PyTorch port)")
    ap.add_argument("--board", default="synthetic")
    ap.add_argument("--out", default="new_data")
    ap.add_argument("--reps", type=int, default=None,
                    help="trials per word (default: the .psyexp's nReps "
                         "when --psyexp is given, else 10)")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="schedule shuffle seed (default: the .psyexp's "
                         "loop seed when --psyexp is given, else 0)")
    ap.add_argument("--words-csv", default=None,
                    help="PsychoPy-style conditions file (words header)")
    ap.add_argument("--psyexp", default=None,
                    help="PsychoPy Builder .psyexp to drive the session: "
                         "beep/word/cool-off timings + vocabulary parsed "
                         "from the XML (collector/psyexp.py); --reps, "
                         "--seed and --words-csv override when given")
    ap.add_argument(
        "--stimulus", nargs="?", const="terminal", default=None,
        choices=("terminal", "web"),
        help="present the protocol to a human subject: 'terminal' (ANSI "
             "word display + bell beep, ESC/q aborts; the default when "
             "the flag is given bare) or 'web' (browser page with a real "
             "WebAudio beep + word card, Escape aborts — "
             "collector/web_stimulus.py)",
    )
    ap.add_argument("--stimulus-port", type=int, default=8778,
                    help="port for --stimulus web (0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="torch device of the filter chain (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raise before the board starts

    base_cfg = None
    if args.psyexp:
        from neural_speech_decoding_tpu_torch.collector.psyexp import load_psyexp

        base_cfg = load_psyexp(args.psyexp)
    words = (
        load_words_csv(args.words_csv)
        if args.words_csv
        else (base_cfg.words if base_cfg else DEFAULT_WORDS)
    )
    presenter = None
    if args.stimulus == "web":
        from neural_speech_decoding_tpu_torch.collector.web_stimulus import WebPresenter

        presenter = WebPresenter(port=args.stimulus_port)
    elif args.stimulus == "terminal":
        from neural_speech_decoding_tpu_torch.collector.stimulus import TerminalPresenter

        presenter = TerminalPresenter()
    board = None
    try:
        # board setup INSIDE the try: a bad port must still restore the
        # terminal (presenter.close()) on the way out
        board = open_board(args.board, speed=args.speed)
        board.prepare_session()
        board.start_stream()
        # CLI flags override the .psyexp only when actually given (the
        # parsed nReps/seed must survive bare `--psyexp file` runs)
        n_reps = args.reps if args.reps is not None else (
            base_cfg.n_reps if base_cfg else 10)
        seed = args.seed if args.seed is not None else (
            base_cfg.seed if base_cfg else 0)
        cfg = (
            dataclasses.replace(base_cfg, words=words, n_reps=n_reps, seed=seed)
            if base_cfg
            else ExperimentConfig(words=words, n_reps=n_reps, seed=seed)
        )
        paths = run_experiment(
            board, args.out, cfg,
            on_trial=None if args.stimulus
            else (lambda i, w, p: print(f"trial {i:03d} word={w} -> {p}")),
            presenter=presenter,
            device=device,
        )
        if presenter is not None:
            presenter.close()  # stop the key listener, restore echo
            presenter = None
        print(f"wrote {len(paths)} trials to {args.out}")
    finally:
        if presenter is not None:
            presenter.close()
        if board is not None:
            board.stop_stream()
            board.release_session()


if __name__ == "__main__":
    main()
