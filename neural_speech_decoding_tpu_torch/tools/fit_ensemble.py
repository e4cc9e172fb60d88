"""Fit a deployment seed ensemble: K full-dataset training runs -> K .npz.

Counterpart of tools/fit_ensemble.py of the JAX package, on the port's
trainer. The claim-grade accuracy of an ensemble is its nested-CV estimate
(tools/crossval.py --seeds K); this tool makes the matching deployment
artifact: the same configuration refit K times on all trials with the
fixed epoch budget and no checkpoint selection, one member per seed,
written by the port's `save_params_npz`, plus a manifest with the JAX
tool's fields. Both packages' `EnsembleEngine.from_manifest` serve it.

The dataset is MAI-filtered once in fast mode on the device (one
pair-sums launch). A family with a fit (the logcov whitener) fits it once
on the full clean filtered dataset and shares it across members, as
crossval's members share their fold's whitener.

  python -m neural_speech_decoding_tpu_torch.tools.fit_ensemble --model logcov8 \\
      --model-kw whiten=true --model-kw dropout=0.0 --seeds 5 \\
      --out-prefix checkpoints/logcov8wd_ens [--device cpu]

  ->  checkpoints/logcov8wd_ens_s0.npz ... _s4.npz  +  _manifest.json
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
from neural_speech_decoding_tpu_torch.io.params_io import save_params_npz
from neural_speech_decoding_tpu_torch.models.registry import family_model_kw, get_model, parse_model_kw
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.tools.crossval import tree_map
from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, train
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def fit_ensemble(
    out_prefix: str,
    model: str = "tcn",
    seeds: int = 5,
    epochs: int = 120,
    augment: float = 0.5,
    aug_kinds: str = "noise",
    label_smoothing: float = 0.1,
    lr: float = 1e-3,
    schedule: str = "constant",
    base_seed: int = 0,
    model_kw: Optional[dict] = None,
    device: DeviceLike = None,
    verbose: bool = True,
) -> str:
    """Train `seeds` members per family of `model` ("famA+famB" mixes) on
    the trials under $NSD_DATA_DIR; write them and the manifest. Returns
    the manifest's path."""
    dev = resolve_device(device)
    model_kw = model_kw or {}
    families = [f.strip() for f in model.split("+") if f.strip()]
    specs = {fam: get_model(fam, **family_model_kw(model_kw, fam)) for fam in families}
    if len({len(s.class_names) for s in specs.values()}) != 1:
        raise SystemExit(f"mixed families disagree on class count: {model}")
    if len(specs[families[0]].class_names) == 5:
        ds = load_trials(class_prefixes=FIVE_CLASS_PREFIXES)
    else:
        ds = load_trials()
    # the filter once; every member trains on the serving precision path
    preprocessed = mai_filter_batch(ds.windows, FilterConfig(precision="fast"), device=dev).cpu().numpy()
    labels = ds.labels.astype(np.int32)

    members, member_families = [], []
    total = seeds * len(families)
    for fam in families:
        fam_spec = specs[fam]
        fam_kw = family_model_kw(model_kw, fam)
        for s in range(seeds):
            # crossval's member-seed derivation (fold 0 slot)
            member_seed = base_seed + 9973 * s
            train_cfg = TrainConfig(
                learning_rate=lr, epochs=epochs, batch_size=32,
                label_smoothing=label_smoothing, seed=member_seed,
                schedule=schedule, augment_prob=augment, augment_kinds=aug_kinds,
                # deployment fit: fixed budget, a tiny val split for logging
                val_fraction=0.05, keep_best=False,
            )
            if verbose:
                print(f"[member {len(members) + 1}/{total}] {fam} seed={member_seed}", flush=True)
            init_params = None
            if fam_spec.fit is not None:
                # the family's init from train()'s generator seed, and the
                # whitener fitted on the full clean dataset
                generator = torch.Generator(device=dev)
                generator.manual_seed(member_seed)
                fitted = fam_spec.fit(fam_spec.init(generator), preprocessed, labels)
                init_params = tree_map(lambda t: t.cpu().numpy(), fitted)
            params, history = train(
                ds, train_cfg=train_cfg, model=fam, model_kw=fam_kw,
                preprocessed=preprocessed, verbose=False, init_params=init_params, device=dev,
            )
            suffix = f"_{fam}_s{s}" if len(families) > 1 else f"_s{s}"
            out = f"{out_prefix}{suffix}.npz"
            save_params_npz(out, params)
            if verbose:
                print(f"  saved {out} ({len(history)} epochs, final train acc "
                      f"{history[-1].get('train_accuracy', float('nan')):.3f})", flush=True)
            members.append(out)
            member_families.append(fam)

    manifest = {
        "model": model,
        "members": members,
        "families": member_families,
        "config": {
            "epochs": epochs, "augment": augment, "aug_kinds": aug_kinds,
            "label_smoothing": label_smoothing, "lr": lr,
            "schedule": schedule, "base_seed": base_seed,
            "model_kw": model_kw,
        },
        "serve_with": "neural_speech_decoding_tpu_torch.runtime.EnsembleEngine",
    }
    manifest_path = f"{out_prefix}_manifest.json"
    Path(manifest_path).write_text(json.dumps(manifest, indent=2))
    if verbose:
        print(f"wrote {manifest_path}", flush=True)
    return manifest_path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Fit a deployment seed ensemble (PyTorch port)")
    ap.add_argument("--model", default="tcn")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--augment", type=float, default=0.5)
    ap.add_argument("--aug-kinds", default="noise", choices=("noise", "all"))
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="constant", choices=("constant", "cosine"))
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--out-prefix", required=True)
    ap.add_argument("--model-kw", action="append", default=[], metavar="KEY=VALUE",
                    help="model-config override forwarded to the registry (repeatable); recorded in the "
                         "manifest so EnsembleEngine.from_manifest rebuilds the same config")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    fit_ensemble(
        args.out_prefix, model=args.model, seeds=args.seeds, epochs=args.epochs,
        augment=args.augment, aug_kinds=args.aug_kinds, label_smoothing=args.label_smoothing,
        lr=args.lr, schedule=args.schedule, base_seed=args.base_seed,
        model_kw=parse_model_kw(args.model_kw), device=args.device,
    )


if __name__ == "__main__":
    main()
