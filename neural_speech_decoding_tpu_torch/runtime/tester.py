"""Trial orchestrator — the public `run_trials` API.

Counterpart of neural_speech_decoding_tpu/runtime/tester.py (signature and
semantics of the reference's Neuro-Alpha-App/Utilities/tester.py:30-110):

  run_trials(trials=10, serial_port=..., num_channels=8,
             window_seconds=5.0, model_path=..., verbose=True)
      -> TrialResult(trials, avg_probs[3], avg_chunk[T, C])

  * starts the streaming producer and sets its recording flag,
  * collects `trials` windows from a bounded drop-oldest queue with a 6.5 s
    consumer timeout and a producer-liveness check,
  * builds the engine lazily from the *stream's* reported sample rate,
    with the reference's ("Food", "Water", "None") class-name spelling for
    the 3-class LSTM,
  * averages softmax probabilities AND the raw (unfiltered) chunks, as the
    reference does,
  * tears down via flag-off, stop(), join(5 s) in a finally block.

The engine decodes with its default fast filter, which on the card is the
pair-sums CUDA kernel. (The JAX tester passes PipelineConfig(), whose
"highest" filter is float32 stages on a TPU and would be float64 here.)
The engine runs on CUDA unless `device="cpu"` is passed. `serial_port`
takes a board spec ("synthetic", "replay:<file.npy>") or a Board object.

CLI (`main`, the counterpart of the JAX `nsd-decode`): serve a checkpoint
of any family of the registry (`--family`), or a fit_ensemble manifest
through EnsembleEngine (single-family, or mixed with a "families" list),
e.g. the flagship, or a TCN checkpoint:

  python -m neural_speech_decoding_tpu_torch.runtime.tester \
      --model checkpoints/logcov8wd_ens_manifest.json --board synthetic --speed 64
  python -m neural_speech_decoding_tpu_torch.runtime.tester \
      --model checkpoints/tcn3_deploy.npz --family tcn --board synthetic --speed 64
"""

from __future__ import annotations

import os
import queue
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from neural_speech_decoding_tpu_torch.models.registry import available_models, parse_model_kw
from neural_speech_decoding_tpu_torch.runtime.board import open_board
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
from neural_speech_decoding_tpu_torch.runtime.streaming import StreamingProducer
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device
from neural_speech_decoding_tpu_torch.utils.timing import LatencyStats

# The reference's default is a hardware serial port; without hardware the
# default board is synthetic. Override with $NSD_BOARD.
DEFAULT_SERIAL = os.environ.get("NSD_BOARD", "synthetic")

# The 3-class LSTM checkpoint shipped in this repository.
_SHIPPED_MODEL = Path(__file__).resolve().parents[2] / "checkpoints" / "lstm3_retrained.npz"


def default_model_path() -> str:
    """$NSD_MODEL, else the repository's shipped 3-class checkpoint."""
    env = os.environ.get("NSD_MODEL")
    if env:
        return env
    if _SHIPPED_MODEL.is_file():
        return str(_SHIPPED_MODEL)
    raise FileNotFoundError("no decoder checkpoint: set $NSD_MODEL or pass model_path")


@dataclass
class TrialResult:
    trials: int
    avg_probs: Optional[np.ndarray]
    avg_chunk: Optional[np.ndarray] = None


@dataclass
class RunStats:
    """Latency and throughput of one run."""

    latency: LatencyStats = field(
        default_factory=lambda: LatencyStats(name="trial_to_prediction")
    )
    predict_latency: LatencyStats = field(
        default_factory=lambda: LatencyStats(name="predict_only")
    )
    wall_seconds: float = 0.0
    windows_per_second: float = 0.0
    labels: list = field(default_factory=list)


def run_trials_ex(
    trials: int = 10,
    serial_port=DEFAULT_SERIAL,
    num_channels: int = 8,
    window_seconds: float = 5.0,
    model_path: Optional[str] = None,
    verbose: bool = True,
    *,
    engine: Optional[InferenceEngine] = None,
    queue_timeout: float = 6.5,
    model: str = "lstm",
    device: DeviceLike = None,
):
    """run_trials + RunStats. See the module docstring for semantics.
    `model` is a family of models/registry.py; `device` places a lazily
    built engine."""
    if engine is None:
        device = resolve_device(device)  # raise before the producer starts
        if model_path is None:
            model_path = default_model_path()

    q: "queue.Queue" = queue.Queue(maxsize=8)
    producer = StreamingProducer(
        serial_port,
        num_channels=num_channels,
        window_seconds=window_seconds,
        out_queue=q,
    )
    producer.start()
    producer.recording_flag.value = True

    stats = RunStats()
    collected = 0
    sum_probs: Optional[np.ndarray] = None
    sum_chunk: Optional[np.ndarray] = None
    t_start = time.perf_counter()

    try:
        while collected < trials:
            if not producer.is_alive():
                err = producer.error
                raise RuntimeError(
                    f"Producer exited unexpectedly{f': {err}' if err else ''}"
                )
            try:
                item = q.get(timeout=queue_timeout)
            except queue.Empty:
                if verbose:
                    print("Waiting for chunk...", flush=True)
                continue

            chunk = np.asarray(item["data"])
            sr = item["sr"]

            if engine is None:
                # lazy construction with the stream's sr; the 3-class LSTM
                # keeps the reference call site's class-name spelling
                engine = InferenceEngine(
                    model_path,
                    class_names=("Food", "Water", "None") if model == "lstm" else None,
                    sample_rate=sr,
                    model=model,
                    device=device,
                )

            t_pred0 = time.perf_counter()
            probs, label = engine.predict(chunk)
            t_done = time.perf_counter()
            stats.predict_latency.record(t_done - t_pred0)
            stats.latency.record(time.time() - item["t_emit"])
            stats.labels.append(label)

            if sum_probs is None:
                sum_probs = np.zeros(len(probs), dtype=np.float32)
            sum_probs += probs
            sum_chunk = chunk if sum_chunk is None else sum_chunk + chunk
            collected += 1

            if verbose:
                stamp = time.strftime("%H:%M:%S")
                print(
                    f"[Trial {collected:02d} @ {stamp}] pred={label} "
                    f"probs={np.round(probs, 3)}",
                    flush=True,
                )

        avg_probs = (sum_probs / collected) if collected else None
        avg_chunk = (sum_chunk / collected) if (collected and sum_chunk is not None) else None
        stats.wall_seconds = time.perf_counter() - t_start
        if stats.wall_seconds > 0:
            stats.windows_per_second = collected / stats.wall_seconds
        if verbose:
            if avg_probs is not None:
                print(f"\nAveraged over {collected} trials: {np.round(avg_probs, 3)}")
                print(str(stats.latency))
            else:
                print("No trials completed; no average available.")
        return TrialResult(trials=collected, avg_probs=avg_probs, avg_chunk=avg_chunk), stats
    finally:
        producer.recording_flag.value = False
        producer.stop()
        producer.join(timeout=5.0)


def run_trials(
    trials: int = 10,
    serial_port=DEFAULT_SERIAL,
    num_channels: int = 8,
    window_seconds: float = 5.0,
    model_path: Optional[str] = None,
    verbose: bool = True,
    *,
    device: DeviceLike = None,
) -> TrialResult:
    """Reference-parity entry point (tester.py:30-37), plus `device`."""
    result, _ = run_trials_ex(
        trials=trials,
        serial_port=serial_port,
        num_channels=num_channels,
        window_seconds=window_seconds,
        model_path=model_path,
        verbose=verbose,
        device=device,
    )
    return result


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Run a decoding snapshot (PyTorch port)")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--board", default=DEFAULT_SERIAL,
                    help="board spec: synthetic | replay:<file.npy>")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay/synthetic time acceleration")
    ap.add_argument(
        "--model", default=None,
        help="checkpoint path (.pth or .npz), or a fit_ensemble "
             "*_manifest.json to serve its ensemble (one family or a mix)",
    )
    ap.add_argument("--family", default="lstm",
                    help="decoder family of --model (a checkpoint): "
                         + " | ".join(available_models())
                         + "; a manifest names its own family or families")
    ap.add_argument(
        "--model-kw", action="append", default=[], metavar="KEY=VALUE",
        help="model-config override for the family (repeatable), e.g. "
             "--model-kw whiten=true for a whitened logcov checkpoint",
    )
    ap.add_argument("--combine", default="mean", choices=("mean", "median"),
                    help="ensemble member combiner (manifest serving only)")
    ap.add_argument("--window-seconds", type=float, default=5.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    board = args.board
    if args.speed != 1.0:
        board = open_board(args.board, speed=args.speed)
    model_kw = parse_model_kw(args.model_kw)

    engine = None
    if args.model and args.model.endswith(".json"):
        # explicit --model-kw overrides win over the manifest's recorded kw
        engine = EnsembleEngine.from_manifest(
            args.model, combine=args.combine, device=args.device,
            **({"model_kw": model_kw} if model_kw else {}),
        )
    elif model_kw:
        engine = InferenceEngine(
            args.model or default_model_path(),
            model=args.family,
            model_kw=model_kw,
            class_names=("Food", "Water", "None") if args.family == "lstm" else None,
            device=args.device,
        )

    _, stats = run_trials_ex(
        trials=args.trials,
        serial_port=board,
        window_seconds=args.window_seconds,
        model_path=None if engine is not None else args.model,
        model=args.family,
        engine=engine,
        device=args.device,
    )
    print(f"windows/s: {stats.windows_per_second:.3f}  {stats.latency}")


if __name__ == "__main__":
    main()
