"""End-to-end quickstart: every major surface of the port in one file.

  python -m neural_speech_decoding_tpu_torch.quickstart [--device cpu] [--data-dir DIR]

Counterpart of examples/quickstart.py. Walks through: dataset load ->
checkpoint ingest -> batched decode -> reference-parity run_trials over
a replay board at 64x -> continuous streaming decode -> bulk recording
decode -> filter-quality metrics -> the accuracy flagship (the shipped
seed ensemble manifest). The trials come from `--data-dir`, else
$NSD_DATA_DIR; with neither, synthetic 3-class trials are written to a
temporary directory (io/dataset.write_synthetic_trials). It runs on the
current CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from neural_speech_decoding_tpu_torch.analysis.metrics import compute_filter_metrics, format_metrics
from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import default_data_dir, load_trials, write_synthetic_trials
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.board import ReplayBoard
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder
from neural_speech_decoding_tpu_torch.runtime.tester import default_model_path, run_trials_ex
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

MANIFEST = Path(__file__).resolve().parents[1] / "checkpoints" / "logcov8wd_ens_manifest.json"
SYNTHETIC_PER_CLASS = 6  # 18 trials: the 16-window decodes need 16


def run(data_dir, device: DeviceLike = None) -> dict:
    """The walk-through on the trials under `data_dir`; returns what each
    step printed, as numbers, with the first 16 windows' probabilities of
    the batched and the ensemble decode."""
    dev = resolve_device(device)
    out = {}
    print(f"device: {dev}")

    # 1. data + model
    ds = load_trials(data_dir)
    print(f"dataset: {len(ds)} trials {dict(zip(ds.class_prefixes, ds.class_counts().tolist()))}")
    engine = InferenceEngine(default_model_path(), class_names=("Food", "Water", "None"), device=dev)
    engine.warmup([1])

    # 2. batched decode
    probs = out["batch_probs"] = engine.predict_batch(ds.windows[:16])
    out["batch_accuracy"] = float((probs.argmax(1) == ds.labels[:16]).mean())
    print(f"batched decode: {len(probs)} windows, accuracy vs labels {out['batch_accuracy']:.2f}")

    # 3. reference-parity snapshot over an accelerated replay board
    result, stats = run_trials_ex(trials=5, serial_port=ReplayBoard(ds.windows[:5], speed=64.0),
                                  verbose=False, engine=engine)
    out["run_trials"] = result
    print(f"run_trials: {result.trials} trials, avg_probs {np.round(result.avg_probs, 3)}, {stats.latency}")

    # 4. continuous streaming decode (sliding windows)
    dec = StreamDecoder(engine, ReplayBoard(ds.windows[:5], speed=64.0), hop_seconds=1.0, average_n=5)
    preds, sstats = dec.run(5, timeout=120)
    out["stream_predictions"] = len(preds)
    print(f"stream: {len(preds)} predictions, {sstats.latency}")

    # 5. bulk recording decode
    recording = np.concatenate(list(ds.windows[:6]), axis=0)
    rec_probs, starts = engine.decode_recording(recording, hop_seconds=2.5)
    out["recording_windows"] = int(rec_probs.shape[0])
    print(f"recording decode: {rec_probs.shape[0]} windows from {recording.shape[0] / 125:.0f}s of signal")

    # 6. filter-quality metrics
    raw = ds.windows[0]
    filt = mai_filter_batch(raw[None], FilterConfig(precision="fast"), device=dev)[0].cpu().numpy()
    m = compute_filter_metrics(raw.T.astype(np.float64), filt.T.astype(np.float64), fs=125.0)
    out["filter_metrics"] = m
    print("filter:", format_metrics(m))

    # 7. the accuracy flagship: the deployed 5-seed whitened-logcov
    # ensemble (members share one whitener, so features are extracted
    # once for all heads). Skipped if the checkout has no checkpoints.
    if MANIFEST.is_file():
        ens = EnsembleEngine.from_manifest(str(MANIFEST), device=dev)
        eprobs = out["ensemble_probs"] = ens.predict_batch(ds.windows[:16])
        out["ensemble_accuracy"] = float((eprobs.argmax(1) == ds.labels[:16]).mean())
        print(f"ensemble decode: {ens.num_members} members (shared featurization: {ens._shared_featurize}), "
              f"16-window accuracy {out['ensemble_accuracy']:.2f}, guard stats {ens.stats}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The port's quickstart")
    ap.add_argument("--data-dir", default=None, help="trial CSVs (default: $NSD_DATA_DIR, else synthetic)")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raise before writing anything
    data_dir = args.data_dir or default_data_dir()
    if data_dir is not None:
        return run(data_dir, args.device)
    with tempfile.TemporaryDirectory(prefix="nsd_quickstart_") as tmp:
        print(f"no --data-dir or $NSD_DATA_DIR: {3 * SYNTHETIC_PER_CLASS} synthetic trials in {tmp}")
        return run(write_synthetic_trials(tmp, SYNTHETIC_PER_CLASS, seed=0), args.device)


if __name__ == "__main__":
    main()
