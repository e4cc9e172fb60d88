"""Model-selection sweep: a grid of configurations -> nested K-fold CV each
-> a ranked table -> optionally the winner trained on the full dataset and
its checkpoint saved. Counterpart of the repository's tools/sweep.py.

Every candidate is scored with nested epoch selection (tools/crossval.py),
the comparison is ranked on that unbiased column, and only then is a
deployment checkpoint fit on all data. The trials come from $NSD_DATA_DIR
(io/dataset.load_trials).

  python -m neural_speech_decoding_tpu_torch.tools.sweep --grid default --folds 5 --out sweep.json
  python -m neural_speech_decoding_tpu_torch.tools.sweep --grid default --train-winner winner.npz

`--reference` scores a reference LSTM checkpoint on the same folds, the
column the JAX tool always fills; `--device` as in the other tools (CUDA
unless named).
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

from neural_speech_decoding_tpu_torch.tools.crossval import run_crossval

# Named grids: lists of axis dicts expanded as a cross product.
GRIDS = {
    # the round-2 exploration grid over the strongest family
    "default": {
        "model": ["tcn", "tcn_small", "tcn_wide"],
        "augment": [0.5, 1.0],
        "aug_kinds": ["all"],
    },
    # quick smoke grid (CI-sized)
    "smoke": {
        "model": ["lstm"],
        "augment": [0.0],
        "epochs": [2],
        "folds": [2],
    },
    # the accuracy-flagship family: model_kw axes sweep config fields the
    # registry exposes through get_model(**kw)
    "logcov": {
        "model": ["logcov8"],
        "model_kw": [
            {},
            {"dropout": 0.0},
            {"whiten": True, "dropout": 0.0},
        ],
        "augment": [0.5],
    },
}


def expand(grid: dict) -> list[dict]:
    keys = sorted(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(grid[k] for k in keys))]


def train_winner(best: dict, out: str, device=None) -> None:
    """Train the best configuration on all trials (the sweep's epoch budget,
    a 5 % validation split for logging only, no selection on it) and save
    its parameters to `out` (.npz)."""
    from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, FilterConfig
    from neural_speech_decoding_tpu_torch.io.dataset import load_trials
    from neural_speech_decoding_tpu_torch.io.params_io import save_params_npz
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, train

    cfg = best["config"]
    model_kw = cfg.get("model_kw") or {}
    spec = get_model(best["model"], **model_kw)
    ds = load_trials(class_prefixes=FIVE_CLASS_PREFIXES) if len(spec.class_names) == 5 else load_trials()
    train_cfg = TrainConfig(
        learning_rate=cfg["lr"], epochs=cfg["epochs"], batch_size=32,
        label_smoothing=cfg["label_smoothing"], seed=cfg["seed"],
        schedule=cfg["schedule"], augment_prob=cfg["augment"],
        augment_kinds=cfg["aug_kinds"],
        val_fraction=0.05, keep_best=False,
    )
    # the filter the CV scored with (and that inference serves)
    params, history = train(
        ds, train_cfg=train_cfg, model=best["model"], model_kw=model_kw,
        filter_cfg=FilterConfig(precision="fast"), device=device,
    )
    save_params_npz(out, params)
    print(f"saved {out} ({len(history)} epochs)")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="Model-selection sweep (PyTorch port)")
    ap.add_argument("--grid", default="default", choices=sorted(GRIDS))
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument(
        "--train-winner", default=None,
        help="after the sweep, train the best config on ALL data and save "
             "its params to this .npz",
    )
    ap.add_argument("--reference", default=None, metavar="PATH",
                    help="a reference LSTM checkpoint (.pth or .npz) scored on the same folds")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    results = []
    combos = expand(GRIDS[args.grid])
    for i, combo in enumerate(combos):
        cfg = {"folds": args.folds, "epochs": args.epochs, **combo}
        print(f"[{i + 1}/{len(combos)}] {cfg}", flush=True)
        summary = run_crossval(verbose=False, reference=args.reference, device=args.device, **cfg)
        row = summary["by_protocol"]["nested"]
        print(f"    nested {row['mean']:.3f} ± {row['std']:.3f}", flush=True)
        results.append(summary)

    results.sort(key=lambda s: -s["by_protocol"]["nested"]["mean"])
    print("\nrank  nested        last          biased        config")
    for s in results:
        by = s["by_protocol"]
        print(
            f"  {by['nested']['mean']:.3f}±{by['nested']['std']:.3f}  "
            f"{by['last']['mean']:.3f}±{by['last']['std']:.3f}  "
            f"{by['biased']['mean']:.3f}±{by['biased']['std']:.3f}  "
            f"{s['model']} {s['config']}"
        )
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))

    if args.train_winner:
        best = results[0]
        print(f"\ntraining winner on the full dataset: {best['model']} {best['config']}")
        train_winner(best, args.train_winner, device=args.device)
    return results


if __name__ == "__main__":
    main()
