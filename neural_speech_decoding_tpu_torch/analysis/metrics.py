"""Signal-quality metrics for filter evaluation (the port's own copy of
neural_speech_decoding_tpu/analysis/metrics.py: numpy only).

Behavioral parity with the reference's offline analysis tool (reference:
MindsAI/examples/Minds_AI_Filter_Offline_Signal_Analysis.py:259-321,
example output MindsAI/examples/data/data_mai_metrics_1e-34_*.json):
per-channel SNR of the filtered signal against the removed component
(raw - filtered), peak/variance impact, baseline shift, and boolean tags
with the same thresholds and JSON schema.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# Tag thresholds, identical to the reference's (reference:
# Minds_AI_Filter_Offline_Signal_Analysis.py:49-51 and the shipped metrics
# JSON's "thresholds" block).
ARTIFACT_SUPPRESSION_THRESH_PCT = 20.0
DRIFT_THRESH_UV = 5.0
VARIANCE_SMOOTHING_THRESH_PCT = 5.0

SNR_METHODS = ("power_ratio", "variance_ratio", "amplitude_ratio")


def snr_db(signal: np.ndarray, noise: np.ndarray, method: str = "power_ratio") -> float:
    """10*log10 of signal/noise under the chosen statistic. +inf -> nan-safe
    None is handled by the caller (reference returns None for inf)."""
    if method == "power_ratio":
        s, n = float(np.mean(signal**2)), float(np.mean(noise**2))
    elif method == "variance_ratio":
        s, n = float(np.var(signal)), float(np.var(noise))
    elif method == "amplitude_ratio":
        s, n = float(np.mean(np.abs(signal))), float(np.mean(np.abs(noise)))
    else:
        raise ValueError(f"unknown SNR method {method!r}; options: {SNR_METHODS}")
    if n <= 0:
        return float("inf")
    return 10.0 * math.log10(s / n)


def compute_filter_metrics(
    raw_ct: np.ndarray,
    filtered_ct: np.ndarray,
    fs: float,
    channel: int = 0,
    method: str = "power_ratio",
    lambd: Optional[float] = None,
) -> Dict:
    """Metrics dict (reference JSON schema) for one analyzed channel.

    raw/filtered: [C, T] in microvolts.
    """
    if raw_ct.shape != filtered_ct.shape:
        raise ValueError(f"shape mismatch {raw_ct.shape} vs {filtered_ct.shape}")
    ch_raw = raw_ct[channel]
    ch_filt = filtered_ct[channel]

    peak_before = float(np.max(np.abs(ch_raw)))
    peak_after = float(np.max(np.abs(ch_filt)))
    var_before = float(np.var(ch_raw))
    var_after = float(np.var(ch_filt))

    impact = {
        "peak_before": peak_before,
        "peak_after": peak_after,
        "peak_reduction": peak_before - peak_after,
        "mean_shift": float(np.mean(ch_filt) - np.mean(ch_raw)),
        "median_shift": float(np.median(ch_filt) - np.median(ch_raw)),
        "artifact_variance_reduction_pct": (
            (var_before - var_after) / var_before * 100.0 if var_before > 0 else 0.0
        ),
    }

    value = snr_db(ch_filt, ch_raw - ch_filt, method)
    return {
        "fs_hz": fs,
        "channels": int(raw_ct.shape[0]),
        "duration_sec": float(raw_ct.shape[1] / fs),
        "lambda": lambd,
        "snr_method": method,
        "snr_db_channel": None if math.isinf(value) else float(value),
        "impact_channel": impact,
        "tags_channel": {
            "artifact_suppression": (
                peak_before > 0
                and (peak_before - peak_after) / peak_before * 100.0
                >= ARTIFACT_SUPPRESSION_THRESH_PCT
            ),
            "drift_correction": (
                abs(impact["mean_shift"]) >= DRIFT_THRESH_UV
                or abs(impact["median_shift"]) >= DRIFT_THRESH_UV
            ),
            "smoothing_effect": impact["artifact_variance_reduction_pct"]
            >= VARIANCE_SMOOTHING_THRESH_PCT,
        },
        "thresholds": {
            "artifact_suppression_pct": ARTIFACT_SUPPRESSION_THRESH_PCT,
            "drift_uv": DRIFT_THRESH_UV,
            "smoothing_pct": VARIANCE_SMOOTHING_THRESH_PCT,
        },
    }


def format_metrics(metrics: Dict) -> str:
    """Human console summary (reference print_metrics_console contract)."""
    value = metrics["snr_db_channel"]
    if value is None:
        snr_text = "inf dB (noise~0)"
    else:
        lin = 10 ** (value / 10.0)
        snr_text = f"{value:.2f} dB (~{lin:.1f}x signal/noise)"
    imp = metrics["impact_channel"]
    peak_pct = (
        imp["peak_reduction"] / imp["peak_before"] * 100.0
        if imp["peak_before"] > 0
        else 0.0
    )
    return (
        f"[SNR {snr_text} | method {metrics['snr_method']}] "
        f"[Peak {imp['peak_before']:.2f}->{imp['peak_after']:.2f} uV "
        f"(down {peak_pct:.0f}%)] "
        f"[Variance down {imp['artifact_variance_reduction_pct']:.1f}%] "
        f"[Shift mean {imp['mean_shift']:+.2f} uV]"
    )


def save_metrics_json(path, metrics: Dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(metrics, indent=2))
