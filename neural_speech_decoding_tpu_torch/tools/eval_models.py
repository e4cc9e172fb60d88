"""Held-out accuracy of every shipped checkpoint, on one split.

Counterpart of tools/eval_models.py of the JAX package. Every model is
evaluated on the SAME held-out stratified split (`--val-fraction` 0.2,
`--seed` 0) of the trials under `--data-dir` ($NSD_DATA_DIR by default),
with the production preprocessing: the fast MAI filter, one pair-sums
launch on the card for each split it filters. The 3-class checkpoints
score the 3-class split; the 5-class ones score the 5-class split, which
is filtered only when the data holds a trial of each of the five class
prefixes. A checkpoint absent from the checkout is skipped.

`--reference PATH` adds the reference LSTM checkpoint (.pth or .npz). It
was trained on (a superset of) these trials, so its number is
optimistic; the others are honest held-out accuracy. Without it there is
no reference row: the port reads no file its caller does not name.

  python -m neural_speech_decoding_tpu_torch.tools.eval_models \\
      --data-dir <trial CSVs> [--reference lstm.pth] [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.engine import load_params
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device

CHECKPOINTS = Path(__file__).resolve().parents[2] / "checkpoints"
REFERENCE_KEY = "reference_lstm (trained on full set, incl. this split)"
# (family, file under checkpoints/) as the JAX tool lists them
THREE_CLASS = (
    ("lstm", "lstm3_retrained.npz"),
    ("eegnet", "eegnet3.npz"),
    ("eegnet", "eegnet3_aug.npz"),
    ("eegnet", "eegnet3_best.npz"),
    ("transformer", "transformer3.npz"),
    ("transformer", "transformer3_aug.npz"),
    ("transformer", "transformer3_best.npz"),
    ("tcn", "tcn3_best.npz"),
    ("tcn", "tcn3_cosine.npz"),
    ("eegnet", "eegnet3_cosine.npz"),
)
FIVE_CLASS = (
    ("lstm5", "lstm5.npz"),
    ("lstm5", "lstm5_best.npz"),
    ("eegnet5", "eegnet5_best.npz"),
    ("transformer5", "transformer5_best.npz"),
    ("tcn5", "tcn5_best.npz"),
)


@torch.no_grad()
def evaluate(spec_name: str, params, windows, labels, *, device: DeviceLike = None) -> float:
    """Accuracy of the family's eval-mode logits on filtered windows
    [N, T, C] (host array or tensor) against labels [N]."""
    dev = resolve_device(device)
    spec = get_model(spec_name)
    x = torch.as_tensor(windows, dtype=torch.float32, device=dev)
    logits = spec.apply(params_from_jax(params, dev), x, train=False)
    return float((logits.argmax(1).cpu().numpy() == np.asarray(labels)).mean())


def _filtered_split(ds, val_fraction: float, seed: int, dev):
    _, val = ds.split(val_fraction, seed=seed)
    return mai_filter_batch(val.windows, FilterConfig(precision="fast"), device=dev), val.labels


def evaluate_all(
    data_dir=None,
    reference: Optional[str] = None,
    val_fraction: float = 0.2,
    seed: int = 0,
    device: DeviceLike = None,
) -> dict:
    """{row name: held-out accuracy}, with the JAX tool's row names."""
    dev = resolve_device(device)
    disable_tf32()
    results = {}

    x3, y3 = _filtered_split(load_trials(data_dir), val_fraction, seed, dev)
    if reference is not None:
        results[REFERENCE_KEY] = evaluate("lstm", load_params(str(reference), "lstm"), x3, y3, device=dev)
    for name, file in THREE_CLASS:
        p = CHECKPOINTS / file
        if p.is_file():
            results[f"{name} ({p.name})"] = evaluate(name, load_params_npz(p), x3, y3, device=dev)

    ds5 = load_trials(data_dir, class_prefixes=FIVE_CLASS_PREFIXES)
    if ds5.class_counts().all():
        x5, y5 = _filtered_split(ds5, val_fraction, seed, dev)
        for name, file in FIVE_CLASS:
            p = CHECKPOINTS / file
            if p.is_file():
                results[f"{name} (5-class, {p.name})"] = evaluate(name, load_params_npz(p), x5, y5, device=dev)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Held-out accuracy of the shipped checkpoints (PyTorch port)")
    ap.add_argument("--data-dir", default=None, help="trial CSVs (default: $NSD_DATA_DIR)")
    ap.add_argument("--reference", default=None, metavar="PATH",
                    help="a reference LSTM checkpoint (.pth or .npz) to add as a row")
    ap.add_argument("--json", default=None)
    ap.add_argument("--val-fraction", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    results = evaluate_all(args.data_dir, args.reference, args.val_fraction, args.seed, device=args.device)
    width = max(len(k) for k in results)
    print(f"{'model':<{width}}  val_acc")
    for k, v in results.items():
        print(f"{k:<{width}}  {v:.3f}")
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
