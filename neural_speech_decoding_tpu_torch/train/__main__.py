"""Training CLI.

  python -m neural_speech_decoding_tpu_torch.train --model logcov8 \
      --model-kw whiten=true --model-kw dropout=0.0 --augment 0.5 \
      --label-smoothing 0.1 --data-dir <trial CSVs> --out member.npz

Counterpart of the JAX package's train/__main__.py, with its flags;
`--device` (default: the CUDA card) replaces its `--platform`. Families
come from the registry; the "5" variants train on the 5-class prefixes.
The windows go through the fast MAI filter (the pair-sums kernel on the
card). The .npz written is a native pytree that the port's
InferenceEngine / run_trials (`--model <path> --family <name>`) serve and
the JAX package's load_params_npz reads.

`--mesh` trains data-parallel (train/loop.py) over every visible card, a
mesh with tp=1, and prints it, as the JAX CLI does; it raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, THREE_CLASS_PREFIXES, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.io.params_io import save_params_npz
from neural_speech_decoding_tpu_torch.models.registry import available_models, get_model, parse_model_kw
from neural_speech_decoding_tpu_torch.parallel.mesh import make_mesh
from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, train


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train an EEG decoder (PyTorch port)")
    ap.add_argument("--model", default="lstm", choices=available_models())
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--augment", type=float, default=0.0, help="noise-injection augmentation probability")
    ap.add_argument("--aug-kinds", default="noise", choices=("noise", "all"),
                    help="'all' adds time_shift/scale/channel_drop")
    ap.add_argument("--schedule", default="constant", choices=("constant", "cosine"))
    ap.add_argument("--patience", type=int, default=0, help="early-stop patience in epochs (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-fraction", type=float, default=0.2)
    ap.add_argument("--lambda", dest="lambd", type=float, default=1.25e-29,
                    help="tailoring lambda for the spatial filter")
    ap.add_argument("--out", default=None, help="output .npz checkpoint path")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--mesh", action="store_true", help="data-parallel training over a mesh (tp=1)")
    ap.add_argument(
        "--model-kw", action="append", default=[], metavar="KEY=VALUE",
        help="model-config override forwarded to the registry (repeatable), "
             "e.g. --model-kw whiten=true; values parse as JSON",
    )
    ap.add_argument("--device", default=None, help="training device (default: the CUDA card; e.g. cpu)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    model_kw = parse_model_kw(args.model_kw)
    spec = get_model(args.model, **model_kw)
    prefixes = FIVE_CLASS_PREFIXES if len(spec.class_names) == 5 else THREE_CLASS_PREFIXES
    ds = load_trials(args.data_dir, class_prefixes=prefixes)
    print(f"dataset: {len(ds)} trials, classes {dict(zip(ds.class_prefixes, ds.class_counts().tolist()))}")

    mesh = None
    if args.mesh:
        mesh = make_mesh(tp=1)
        print(f"mesh: {dict(mesh.shape)}")

    params, history = train(
        ds,
        model=spec,
        train_cfg=TrainConfig(
            learning_rate=args.lr,
            weight_decay=args.weight_decay,
            epochs=args.epochs,
            batch_size=args.batch_size,
            label_smoothing=args.label_smoothing,
            seed=args.seed,
            val_fraction=args.val_fraction,
            augment_prob=args.augment,
            augment_kinds=args.aug_kinds,
            schedule=args.schedule,
            early_stop_patience=args.patience,
        ),
        filter_cfg=FilterConfig(lambd=args.lambd, precision="fast"),
        mesh=mesh,
        device=args.device,
    )

    best = max(history, key=lambda h: h["val_accuracy"])
    print(
        f"final val_acc {history[-1]['val_accuracy']:.3f} "
        f"(best {best['val_accuracy']:.3f} @ epoch {best['epoch']})"
    )
    if args.out:
        save_params_npz(args.out, params)
        print(f"saved checkpoint -> {args.out}")
    if args.history_out:
        Path(args.history_out).write_text(json.dumps(history, indent=1))
        print(f"saved history -> {args.history_out}")


if __name__ == "__main__":
    main()
