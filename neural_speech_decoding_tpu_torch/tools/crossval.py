"""K-fold cross-validated accuracy: the rigorous form of the accuracy claim.

Counterpart of tools/crossval.py of the JAX package, on the port's
trainer. Single 20%-split numbers on 179 trials have +-8% noise; this
trains one model per fold and reports mean +- std held-out accuracy, plus
a reference LSTM checkpoint on the same folds when one is given
(`reference=` / `--reference PATH`; it trained on all of them, so its
number is an upper bound of its held-out accuracy). Without one, the
reference entries are empty: the port reads no file its caller does not
name.

Protocols (--protocol, default "nested"), all computed in one run:
  nested  epoch selection on an inner split carved out of the fold's
          TRAINING set, that epoch's parameters scored on the outer fold
          (unbiased, the headline number);
  last    the final epoch's parameters (unbiased, no selection);
  swa     the mean of the parameters over the last quarter of the epochs;
  biased  max over epochs of the outer-fold accuracy itself (kept only
          for comparison).

--seeds K trains K models per fold and ensembles them by their mean
softmax; "famA+famB" cross-validates a cross-family ensemble of K members
per family.

The numpy draws are the JAX tool's exactly: the folds, the inner splits,
the augmentation and every epoch's batch order. Parameters are drawn from
one torch.Generator a member (seeded with the member's seed), which also
draws dropout and RReLU. The dataset is MAI-filtered once in fast mode
(one pair-sums launch); a family with a parameter-free featurize (logcov)
is featurized once a fold, clean windows and every member's augmented
copies in one call (one band-gram and one feature launch on the whitened
kernel route), and trains in head space.

  python -m neural_speech_decoding_tpu_torch.tools.crossval --model logcov8 \\
      --model-kw whiten=true --model-kw dropout=0.0 --folds 5 --seeds 5 \\
      --json cv.json [--reference lstm.pth] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.registry import family_model_kw, get_model, parse_model_kw
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.train.augment import ALL_KINDS, KINDS, augment_batch_np
from neural_speech_decoding_tpu_torch.train.loop import (
    Optimizer,
    TrainConfig,
    _detached,
    _is_buffer,
    _leaves,
    make_eval_fn,
    make_train_step,
)
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device


def stratified_folds(labels: np.ndarray, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    folds = [[] for _ in range(k)]
    for c in np.unique(labels):
        idx = rng.permutation(np.flatnonzero(labels == c))
        for i, j in enumerate(idx):
            folds[i % k].append(j)
    return [np.sort(np.asarray(f)) for f in folds]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of nested dicts/lists (parallel trees in `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def load_reference(path, device: torch.device):
    """A reference LSTM checkpoint (.pth or .npz) as parameters on `device`."""
    from neural_speech_decoding_tpu_torch.runtime.engine import load_params

    return params_from_jax(load_params(str(path), "lstm"), device)


def run_crossval(
    model: str = "lstm",
    folds: int = 5,
    epochs: int = 120,
    augment: float = 0.5,
    aug_kinds: str = "noise",
    label_smoothing: float = 0.1,
    lr: float = 1e-3,
    schedule: str = "constant",
    seed: int = 0,
    protocol: str = "nested",
    seeds: int = 1,
    model_kw: Optional[dict] = None,
    class_weight: str = "none",
    verbose: bool = True,
    reference: Optional[str] = None,
    device: DeviceLike = None,
) -> dict:
    """K-fold CV of one configuration on the trials under $NSD_DATA_DIR;
    returns the summary dict, with the JAX tool's keys and shapes.

    `reference`: an LSTM checkpoint scored on the same folds (3 classes).
    `device`: CUDA unless named."""

    def log(msg):
        if verbose:
            print(msg, flush=True)

    dev = resolve_device(device)
    disable_tf32()
    families = [f.strip() for f in model.split("+") if f.strip()]
    specs = {name: get_model(name, **family_model_kw(model_kw, name)) for name in families}
    if len({len(s.class_names) for s in specs.values()}) != 1:
        raise ValueError(f"ensemble families disagree on classes: {families}")
    spec_probe = specs[families[0]]
    three_class = len(spec_probe.class_names) == 3
    ds = load_trials() if three_class else load_trials(class_prefixes=FIVE_CLASS_PREFIXES)
    filtered = mai_filter_batch(ds.windows, FilterConfig(precision="fast"), device=dev)
    filtered_np = filtered.cpu().numpy()  # the augmentation draws on the host
    labels_t = torch.as_tensor(ds.labels, dtype=torch.int64, device=dev)
    ref = load_reference(reference, dev) if reference is not None else None
    lstm_spec = get_model("lstm")

    # class-balanced CE: inverse-frequency weights from the global counts
    class_weights = None
    if class_weight == "balanced":
        counts = ds.class_counts().astype(np.float64)
        w = counts.sum() / (len(counts) * np.maximum(counts, 1))
        class_weights = tuple(float(v) for v in w)

    def model_for(n):
        s = specs[n]
        if s.featurize is not None:
            return lambda p, f, *, train=False, generator=None, s=s: s.head_apply(
                p, f, train=train, generator=generator
            )
        return s

    eval_fns = {n: make_eval_fn(model_for(n)) for n in specs}

    def acc_on(family, p, x, y):
        w = torch.ones(x.shape[0], dtype=torch.float32, device=dev)
        return float(eval_fns[family](p, x, y, w)["accuracy"])

    @torch.no_grad()
    def probs_on(family, p, x):
        s = specs[family]
        logits = s.head_apply(p, x) if s.featurize is not None else s.apply(p, x)
        return torch.softmax(logits, dim=-1).cpu().numpy()

    def init_member(family, member_seed, x_base, y_base):
        spec = specs[family]
        generator = torch.Generator(device=dev)
        generator.manual_seed(member_seed)
        params = spec.init(generator)
        if spec.fit is not None:
            # data-dependent init (the logcov whitener) on the fold's CLEAN
            # training windows only
            params = spec.fit(params, x_base, y_base)
        return params, generator

    opt_cfg = TrainConfig(
        learning_rate=lr, epochs=epochs, batch_size=32,
        label_smoothing=label_smoothing, schedule=schedule,
    )

    def train_member(family, member_seed, params, generator, x_train, y_train, xt_ival, y_ival, xt_val, y_val):
        """One training run; epoch selection on the inner split only.
        Returns (family, nested_params, last_params, biased_outer_acc,
        swa_params)."""
        for path, t in _leaves(params):
            t.requires_grad_(not _is_buffer(path))
        optimizer = Optimizer(params, opt_cfg, max(1, x_train.shape[0] // 32))
        step_fn = make_train_step(model_for(family), optimizer, label_smoothing, class_weights=class_weights)
        np_rng = np.random.default_rng(member_seed)
        best_outer = best_inner = -1.0
        nested_params = None
        swa_start = epochs - max(1, epochs // 4)
        swa_params, swa_n = None, 0
        n = x_train.shape[0]
        for epoch in range(epochs):
            perm = torch.as_tensor(np_rng.permutation(n), device=dev)
            for i in range(0, n - 32 + 1, 32):
                idx = perm[i : i + 32]
                step_fn(params, x_train[idx], y_train[idx], generator)
            inner = acc_on(family, params, xt_ival, y_ival)
            if inner > best_inner:
                best_inner = inner
                nested_params = _detached(params)
            if epoch >= swa_start:
                snap = _detached(params)
                swa_params = snap if swa_params is None else tree_map(torch.add, swa_params, snap)
                swa_n += 1
            best_outer = max(best_outer, acc_on(family, params, xt_val, y_val))
        swa_params = tree_map(lambda a: a / swa_n, swa_params)
        return family, nested_params, _detached(params), best_outer, swa_params

    fold_indices = stratified_folds(ds.labels, folds, seed)
    ours = {"nested": [], "last": [], "swa": [], "biased": []}
    seed_means = {"nested": []}
    theirs = []
    fold_detail = []
    for fold_i, val_idx in enumerate(fold_indices):
        train_idx = np.setdiff1d(np.arange(len(ds)), val_idx)
        # the inner split comes out of the fold's TRAINING set only, before
        # augmentation
        inner_val_rel = stratified_folds(ds.labels[train_idx], 6, seed + 100 + fold_i)[0]
        inner_val_idx = train_idx[inner_val_rel]
        inner_train_idx = np.setdiff1d(train_idx, inner_val_idx)
        y_val_np = ds.labels[val_idx]
        x_base, x_ival, x_val = (filtered[torch.as_tensor(i, device=dev)]
                                 for i in (inner_train_idx, inner_val_idx, val_idx))
        y_base, y_ival, y_val = (labels_t[torch.as_tensor(i, device=dev)]
                                 for i in (inner_train_idx, inner_val_idx, val_idx))

        members = []
        val_inputs = {}
        for fam in families:
            spec = specs[fam]
            runs = []
            for s in range(seeds):
                member_seed = seed + fold_i + 9973 * s
                params, generator = init_member(fam, member_seed, x_base, y_base)
                xa = ya = None
                if augment > 0:
                    xa, ya = augment_batch_np(
                        filtered_np[inner_train_idx], ds.labels[inner_train_idx], prob=augment,
                        seed=member_seed, kinds=ALL_KINDS if aug_kinds == "all" else KINDS,
                    )
                runs.append((member_seed, params, generator, xa, ya))
            if spec.featurize is not None:
                # one featurize a fold: the whitener is a deterministic
                # function of the fold's clean training windows, so it is
                # the same in every member
                parts = [x_base, x_ival, x_val] + [
                    torch.as_tensor(xa, device=dev) for _, _, _, xa, _ in runs if xa is not None and len(xa)
                ]
                with torch.no_grad():
                    feats = spec.featurize(runs[0][1], torch.cat(parts))
                chunks = list(torch.split(feats, [p.shape[0] for p in parts]))
                f_base, f_ival, f_val = chunks[:3]
                aug_feats = iter(chunks[3:])
                xt_ival, xt_val = f_ival, f_val
            else:
                xt_ival, xt_val = x_ival, x_val
            val_inputs[fam] = xt_val
            for member_seed, params, generator, xa, ya in runs:
                base = f_base if spec.featurize is not None else x_base
                x_train, y_train = base, y_base
                if xa is not None and len(xa):
                    extra = next(aug_feats) if spec.featurize is not None else torch.as_tensor(xa, device=dev)
                    x_train = torch.cat([base, extra])
                    y_train = torch.cat([y_base, torch.as_tensor(ya, dtype=torch.int64, device=dev)])
                members.append(train_member(
                    fam, member_seed, params, generator, x_train, y_train, xt_ival, y_ival, xt_val, y_val,
                ))

        # ensemble = mean softmax over members, each member's epoch chosen
        # on the inner split
        member_nested_probs = [probs_on(m[0], m[1], val_inputs[m[0]]) for m in members]
        nested_probs = np.mean(member_nested_probs, axis=0)
        last_probs = np.mean([probs_on(m[0], m[2], val_inputs[m[0]]) for m in members], axis=0)
        swa_probs = np.mean([probs_on(m[0], m[4], val_inputs[m[0]]) for m in members], axis=0)
        per_seed_nested = [float((p.argmax(1) == y_val_np).mean()) for p in member_nested_probs]
        ours["nested"].append(float((nested_probs.argmax(1) == y_val_np).mean()))
        ours["last"].append(float((last_probs.argmax(1) == y_val_np).mean()))
        ours["swa"].append(float((swa_probs.argmax(1) == y_val_np).mean()))
        ours["biased"].append(float(np.mean([m[3] for m in members])))
        seed_means["nested"].append(float(np.mean(per_seed_nested)))
        detail = {
            "y_val": [int(v) for v in y_val_np],
            "members": [m[0] for m in members],
            "member_nested_probs": [p.round(5).tolist() for p in member_nested_probs],
        }
        if len(families) == 1 and specs[families[0]].featurize is not None:
            # the held-out tangent features and each member's nested head
            # parameters, for session_eval's pre-softmax aggregation
            detail["val_features"] = val_inputs[families[0]].cpu().numpy().round(5).tolist()
            detail["member_nested_params"] = [
                tree_map(lambda a: a.cpu().numpy().tolist(), m[1]) for m in members
            ]
        fold_detail.append(detail)

        if ref is None:
            ref_text = "n/a"
        else:
            if three_class:
                with torch.no_grad():
                    ref_logits = lstm_spec.apply(ref, x_val).cpu().numpy()
                theirs.append(float((ref_logits.argmax(1) == y_val_np).mean()))
            else:
                theirs.append(float("nan"))  # the reference has no 5-class decoder
            ref_text = f"{theirs[-1]:.3f}"
        ens = f" (per-seed {seed_means['nested'][-1]:.3f})" if len(members) > 1 else ""
        log(
            f"fold {fold_i}: nested {ours['nested'][-1]:.3f}{ens} | "
            f"last {ours['last'][-1]:.3f} | swa {ours['swa'][-1]:.3f} | "
            f"biased {ours['biased'][-1]:.3f} | reference {ref_text}"
        )

    summary = {
        "model": model,
        "folds": folds,
        "protocol": protocol,
        "seeds": seeds,
        "per_seed_nested": {
            "mean": float(np.mean(seed_means["nested"])),
            "std": float(np.std(seed_means["nested"])),
            "folds": seed_means["nested"],
        },
        "ours_mean": float(np.mean(ours[protocol])),
        "ours_std": float(np.std(ours[protocol])),
        "reference_mean": float(np.nanmean(theirs)) if theirs else None,
        "reference_std": float(np.nanstd(theirs)) if theirs else None,
        "by_protocol": {
            name: {"mean": float(np.mean(v)), "std": float(np.std(v)), "folds": v}
            for name, v in ours.items()
        },
        # "biased" averages per-member numbers: it has no ensemble analogue
        "biased_is_per_member": len(families) * seeds > 1,
        "reference": theirs,
        "fold_detail": fold_detail,
        "config": {
            "epochs": epochs, "augment": augment, "aug_kinds": aug_kinds,
            "label_smoothing": label_smoothing, "lr": lr,
            "schedule": schedule, "seed": seed, "seeds": seeds,
            "model_kw": model_kw or {},
            "class_weight": class_weight,
        },
    }
    n_members = len(families) * seeds
    log(f"\n{model} {folds}-fold" + (f", {n_members}-member ensemble" if n_members > 1 else "") + ":")
    for name in ("nested", "last", "swa", "biased"):
        row = summary["by_protocol"][name]
        tag = " (headline)" if name == protocol else ""
        if name == "biased" and summary["biased_is_per_member"]:
            tag += " [per-member mean, not the ensemble]"
        log(f"  {name:7s} {row['mean']:.3f} ± {row['std']:.3f}{tag}")
    if n_members > 1:
        ps = summary["per_seed_nested"]
        log(f"  per-member nested (no ensemble) {ps['mean']:.3f} ± {ps['std']:.3f}")
    if theirs:
        log(f"  reference checkpoint {summary['reference_mean']:.3f} ± {summary['reference_std']:.3f}")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="K-fold cross-validation (PyTorch port)")
    ap.add_argument("--model", default="lstm")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--augment", type=float, default=0.5)
    ap.add_argument("--aug-kinds", default="noise", choices=("noise", "all"))
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--class-weight", default="none", choices=("none", "balanced"),
                    help="'balanced' = inverse-frequency class-weighted CE (global dataset counts)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="constant", choices=("constant", "cosine"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--protocol", default="nested", choices=("nested", "last", "swa", "biased"))
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--model-kw", action="append", default=[], metavar="KEY=VALUE",
                    help="model-config override forwarded to the registry, repeatable; "
                         "values parse as JSON, falling back to string")
    ap.add_argument("--reference", default=None, metavar="PATH",
                    help="a reference LSTM checkpoint (.pth or .npz) scored on the same folds")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    summary = run_crossval(
        model=args.model, folds=args.folds, epochs=args.epochs,
        augment=args.augment, aug_kinds=args.aug_kinds,
        label_smoothing=args.label_smoothing, lr=args.lr,
        schedule=args.schedule, seed=args.seed, protocol=args.protocol,
        seeds=args.seeds, model_kw=parse_model_kw(args.model_kw),
        class_weight=args.class_weight, reference=args.reference, device=args.device,
    )
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
