"""Fidelity report: deltas against a golden dump of the reference, for
every precision mode.

Counterpart of tools/fidelity_report.py of the JAX package. For each mode
it prints the max |delta logit| and max |delta prob| of the LSTM against
the golden dump, and the argmax agreement, over every trial under
`--data-dir` ($NSD_DATA_DIR by default) of the five class prefixes (the
report is label-free). The modes:

  fidelity f64  FilterConfig(precision="highest"): the float64 stages
                filter, on every device
  fast f32      the fast filter: the pair-sums kernel on the card
  turbo bf16    the fast filter and the LSTM's recurrence in bfloat16

With --stages it also bisects the pipeline: the filter stage against the
golden filtered windows (`--golden-filtered`), and the model stage (those
windows through this backend's decoder), so that a miss can be laid on
the filter or the recurrence.

--write-filtered writes the golden filtered windows of the trials to
`--out` (required there) with the reference filter in float64 numpy and
scipy, independent of the port's filter.

  python -m neural_speech_decoding_tpu_torch.tools.fidelity_report \\
      --checkpoint lstm.pth [--golden probs.npz] [--stages \\
      --golden-filtered filtered.npz] [--data-dir DIR] [--json out.json] [--device cpu]
  python -m neural_speech_decoding_tpu_torch.tools.fidelity_report \\
      --write-filtered --out filtered.npz [--data-dir DIR]

The golden dump holds `files`, `logits` and `probs` of the trials in
`load_trials` order (tests/golden/reference_probs.npz is the reference
model's on the 324 recorded trials).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, DecoderConfig, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.engine import load_params
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device

REPO = Path(__file__).resolve().parents[2]
GOLDEN_PROBS = REPO / "tests" / "golden" / "reference_probs.npz"
GOLDEN_FILTERED = REPO / "tests" / "golden" / "reference_filtered.npz"
PRODUCTION_LAMBDA = 1.25e-29  # reference: tester.py:84


def reference_filter(windows_ntc: np.ndarray) -> np.ndarray:
    """The reference filter on each [T, C] window in float64 numpy and
    scipy (reference semantics: MindsAI/mindsai_filter_python/core.py:14-38),
    float32 [N, T, C] out."""
    import scipy.signal

    out = np.empty(np.shape(windows_ntc), dtype=np.float32)
    for i, w in enumerate(windows_ntc):
        y = np.asarray(w, dtype=np.float64).T  # [C, T]
        phases = np.angle(scipy.signal.hilbert(y.T, axis=0))  # [T, C]
        diff = phases[:, :, None] - phases[:, None, :]
        p = np.sum(np.sin(diff) ** 2, axis=0)
        np.fill_diagonal(p, 0.0)
        d = np.sqrt(np.clip(np.diag(p), 1e-12, None))
        p = p / np.outer(d, d)
        c = p.shape[0]
        inv = np.linalg.inv(np.eye(c) + PRODUCTION_LAMBDA * (p.T @ p))
        out[i] = (inv @ y).T.astype(np.float32)
    return out


def write_filtered(ds, out) -> Path:
    """Write {files, filtered} of the dataset's trials to `out`."""
    out = Path(out)
    filtered = reference_filter(ds.windows)
    np.savez_compressed(out, files=np.asarray(ds.files), filtered=filtered)
    print(f"wrote {out} ({filtered.nbytes / 1e6:.1f} MB raw)")
    return out


def modes():
    """(name, filter config, decoder config) of each precision mode."""
    fast = FilterConfig(precision="fast")
    return [
        ("fidelity f64", FilterConfig(precision="highest"), DecoderConfig()),
        ("fast f32", fast, DecoderConfig()),
        ("turbo bf16", fast, dataclasses.replace(DecoderConfig(), recurrence_dtype="bfloat16")),
    ]


def _golden(path, files, keys):
    with np.load(path, allow_pickle=False) as z:
        if list(z["files"]) != list(files):
            raise ValueError(f"{path}: its files are not the trials' ({len(z['files'])} vs {len(files)})")
        return [z[k] for k in keys]


def fidelity_report(
    checkpoint,
    data_dir=None,
    golden=GOLDEN_PROBS,
    golden_filtered=GOLDEN_FILTERED,
    stages: bool = False,
    device: DeviceLike = None,
) -> dict:
    """The report of every mode as a dict (the JAX tool's keys)."""
    dev = resolve_device(device)
    disable_tf32()
    ds = load_trials(data_dir, class_prefixes=FIVE_CLASS_PREFIXES)
    ref_logits, ref_probs = _golden(golden, ds.files, ("logits", "probs"))
    ref_argmax = ref_logits.argmax(1)
    params = params_from_jax(load_params(str(checkpoint), "lstm"), dev)
    filtered_golden = None
    if stages:
        (filtered_golden,) = _golden(golden_filtered, ds.files, ("filtered",))
        filtered_golden = torch.from_numpy(filtered_golden).to(dev)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    report = {"platform": dev.type, "device": kind, "trials": len(ds), "modes": {}}
    print(f"platform: {dev.type} ({kind}) | trials: {len(ds)}")
    header = f"{'mode':14s} {'max|dlogit|':>12s} {'max|dprob|':>11s} {'argmax agree':>13s}"
    if stages:
        header += f" {'filt max|d|':>12s} {'model-only |dlogit|':>20s}"
    print(header)
    for name, fcfg, dcfg in modes():
        filtered = mai_filter_batch(ds.windows, fcfg, device=dev)
        logits = decoder_logits(params, filtered, dcfg)
        probs = torch.softmax(logits, -1).cpu().numpy()
        logits = logits.cpu().numpy()
        dl = float(np.abs(logits - ref_logits).max())
        dp = float(np.abs(probs - ref_probs).max())
        agree = float((logits.argmax(1) == ref_argmax).mean())
        row = {"max_dlogit": dl, "max_dprob": dp, "argmax_agreement": agree}
        line = f"{name:14s} {dl:12.2e} {dp:11.2e} {agree:13.4f}"
        if stages:
            dfilt = float((filtered - filtered_golden).abs().max())
            model_logits = decoder_logits(params, filtered_golden, dcfg).cpu().numpy()
            dmodel = float(np.abs(model_logits - ref_logits).max())
            row.update(filter_max_delta=dfilt, model_only_max_dlogit=dmodel)
            line += f" {dfilt:12.2e} {dmodel:20.2e}"
        report["modes"][name] = row
        print(line)
    return report


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description="Fidelity of each precision mode against a golden dump (PyTorch port)")
    ap.add_argument("--checkpoint", default=None, help="the LSTM checkpoint (.pth or .npz); required to report")
    ap.add_argument("--golden", default=str(GOLDEN_PROBS), help="golden dump of files, logits and probs")
    ap.add_argument("--golden-filtered", default=str(GOLDEN_FILTERED),
                    help="golden filtered windows, read by --stages")
    ap.add_argument("--data-dir", default=None, help="trial CSVs (default: $NSD_DATA_DIR)")
    ap.add_argument("--stages", action="store_true", help="per-stage bisect")
    ap.add_argument("--write-filtered", action="store_true",
                    help="write the reference-filtered windows of the trials to --out, and stop")
    ap.add_argument("--out", default=None, help="output .npz of --write-filtered")
    ap.add_argument("--json", default=None, help="also write the report as JSON")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if args.write_filtered:
        if args.out is None:
            ap.error("--write-filtered needs --out")
        write_filtered(load_trials(args.data_dir, class_prefixes=FIVE_CLASS_PREFIXES), args.out)
        return None
    if args.checkpoint is None:
        ap.error("--checkpoint is required")
    report = fidelity_report(args.checkpoint, args.data_dir, args.golden, args.golden_filtered,
                             stages=args.stages, device=args.device)
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
