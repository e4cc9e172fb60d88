"""Offline filter analysis CLI, the headless equivalent of the reference's
Tk offline demo (reference: MindsAI/examples/Minds_AI_Filter_Offline_Signal_
Analysis.py): robust intake -> unit scale -> mean detrend -> Kuramoto
filter -> SNR/impact metrics -> filtered CSV + metrics JSON export.

Counterpart of neural_speech_decoding_tpu/analysis/offline.py. The filter
is the port's `KuramotoSpatialFilter`: `mai_filter` in "highest" mode
(float64, FFT analytic signal, LU solve) on the device, CUDA unless the
caller names another; its output comes back to the host and is widened to
float64, as in JAX.

  python -m neural_speech_decoding_tpu_torch.analysis.offline data.csv \\
      --lambda 1e-34 --channel 0 --fs 500 --out-dir out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from neural_speech_decoding_tpu_torch.analysis.io import (
    detect_orientation,
    detect_unit_scale,
    read_edf_numeric,
    read_numeric_csv,
)
from neural_speech_decoding_tpu_torch.analysis.metrics import (
    compute_filter_metrics,
    format_metrics,
    save_metrics_json,
)
from neural_speech_decoding_tpu_torch.ops.kuramoto import KuramotoSpatialFilter
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike


def analyze_file(
    path,
    lambd: float = 1e-25,
    channel: int = 0,
    fs: float = 125.0,
    snr_method: str = "power_ratio",
    out_dir=None,
    device: DeviceLike = None,
):
    """Run the offline analysis over one CSV or EDF file.

    Returns (metrics, filtered [C, T] float64). For EDF input the header
    sampling rate overrides the `fs` argument (reference: the Tk tool
    prefills fs from the EDF header)."""
    spatial_filter = KuramotoSpatialFilter(lambd, device=device)
    if str(path).lower().endswith(".edf"):
        data_ct, fs = read_edf_numeric(path)  # the header is authoritative for EDF
    else:
        data_ct = detect_orientation(read_numeric_csv(path))
    scale, unit = detect_unit_scale(data_ct)
    data_uv = data_ct * scale
    # mean detrend per channel (reference behavior)
    raw = data_uv - data_uv.mean(axis=1, keepdims=True)
    filtered = spatial_filter.transform(raw)

    metrics = compute_filter_metrics(
        raw, filtered, fs=fs, channel=channel, method=snr_method, lambd=lambd
    )
    metrics["detected_unit"] = unit

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S")
        stem = Path(path).stem
        np.savetxt(
            out_dir / f"{stem}_mai_filtered_{lambd:g}_{stamp}.csv",
            filtered.T,
            delimiter=",",
            fmt="%.7f",
        )
        save_metrics_json(out_dir / f"{stem}_mai_metrics_{lambd:g}_{stamp}.json", metrics)
    return metrics, filtered


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Offline Kuramoto-filter analysis (PyTorch port)")
    ap.add_argument("path")
    ap.add_argument("--lambda", dest="lambd", type=float, default=1e-25)
    ap.add_argument("--channel", type=int, default=0)
    ap.add_argument("--fs", type=float, default=125.0)
    ap.add_argument("--snr-method", default="power_ratio",
                    choices=("power_ratio", "variance_ratio", "amplitude_ratio"))
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    metrics, _ = analyze_file(
        args.path, lambd=args.lambd, channel=args.channel, fs=args.fs,
        snr_method=args.snr_method, out_dir=args.out_dir, device=args.device,
    )
    print(format_metrics(metrics))


if __name__ == "__main__":
    main()
