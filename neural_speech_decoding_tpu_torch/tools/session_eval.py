"""Session-level accuracy: the product metric of the reference app.

Counterpart of tools/session_eval.py of the JAX package. The reference's
deliverable is not a per-window prediction: `run_trials` collects 10
windows of one imagined word and averages their softmax probabilities
before the argmax (reference: Neuro-Alpha-App/Utilities/tester.py:88-98).
This tool computes that session-level figure from the nested-CV
probabilities of a crossval JSON (`fold_detail`), with no retraining:

  for each outer fold and each class, draw N-window subsets of that
  class's held-out windows, mean the (ensemble) per-window probabilities,
  argmax; accuracy over draws = P(the averaged session prediction is
  right).

The draws are numpy's, the JAX tool's exactly. Where the JSON holds the
held-out tangent features and each member's nested head parameters, it
also averages features before the heads (pre-softmax), and with
--crop-seconds averages features over overlapping sub-windows of each
trial (each crop filtered and featurized on the device). A reference LSTM
checkpoint is scored the same way only when one is given (`reference=` /
`--reference PATH`).

  python -m neural_speech_decoding_tpu_torch.tools.session_eval cv.json \\
      [--reference lstm.pth] [--device cpu]
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
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.tools.crossval import load_reference, stratified_folds
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device


def params_from_lists(obj, device) -> dict:
    """A member's parameters as crossval's JSON stores them (dicts of nested
    lists) -> float32 tensors on `device`."""
    if isinstance(obj, dict):
        return {k: params_from_lists(v, device) for k, v in obj.items()}
    return torch.as_tensor(np.asarray(obj, np.float32), device=device)


def _draw_indices(labels: np.ndarray, n_windows: int, draws: int, rng: np.random.Generator):
    """Per class: [draws, n_windows] index matrix into the fold's held-out
    windows, without replacement when the class has >= n_windows held-out
    windows, with replacement otherwise."""
    out = {}
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        replace = len(idx) < n_windows
        out[int(c)] = np.stack([rng.choice(idx, size=n_windows, replace=replace) for _ in range(draws)])
    return out


def session_accuracy_from_probs(
    probs: np.ndarray,
    labels: np.ndarray,
    *,
    n_windows: int = 10,
    draws: int = 2000,
    rng: np.random.Generator,
) -> float:
    """P(argmax of the mean over an n-window same-class draw is correct)."""
    correct = total = 0
    for c, picks in _draw_indices(labels, n_windows, draws, rng).items():
        pred = probs[picks].mean(axis=1).argmax(axis=1)  # [draws]
        correct += int((pred == c).sum())
        total += picks.shape[0]
    return correct / total


def session_accuracy_feature_avg(
    feats: np.ndarray,
    labels: np.ndarray,
    member_params,
    head_fn,
    *,
    n_windows: int = 10,
    draws: int = 2000,
    rng: np.random.Generator,
) -> float:
    """Session accuracy with pre-softmax integration: the n windows'
    tangent features are averaged per draw, each member's head runs once on
    the averaged features (`head_fn(params, feats) -> probs`), and the
    member softmaxes are averaged."""
    per_class = _draw_indices(labels, n_windows, draws, rng)
    classes = sorted(per_class)
    mean_feats = np.concatenate([feats[per_class[c]].mean(axis=1) for c in classes])
    probs = np.mean([np.asarray(head_fn(p, mean_feats)) for p in member_params], axis=0)
    pred = probs.argmax(axis=1).reshape(len(classes), -1)
    truth = np.asarray(classes)[:, None]
    return float((pred == truth).mean())


def crop_features(
    windows_raw: np.ndarray,
    member_params,
    featurize_fn,
    filter_fn,
    *,
    crop_seconds: float,
    crop_hop_seconds: float,
    sample_rate: int = 125,
    include_full: bool = True,
) -> np.ndarray:
    """Test-time time-crop aggregation: each overlapping sub-window of each
    raw trial is filtered as its own window (`filter_fn`) and featurized
    with the fold's whitener (`featurize_fn(params, filtered)`), and the
    crops' features are averaged per trial (plus the full window when
    `include_full`). Returns [n_trials, F]."""
    t = windows_raw.shape[1]
    crop_len = max(1, int(crop_seconds * sample_rate))
    hop = max(1, int(crop_hop_seconds * sample_rate))
    crops = [windows_raw[:, o : o + crop_len] for o in range(0, t - crop_len + 1, hop)]
    if include_full and crop_len != t:
        crops.append(windows_raw)
    # crossval's member whiteners are identical, so one member featurizes
    p0 = member_params[0]
    feats = [np.asarray(featurize_fn(p0, filter_fn(np.ascontiguousarray(c)))) for c in crops]
    return np.mean(feats, axis=0)


def evaluate(
    cv_json: str,
    n_windows: int = 10,
    draws: int = 2000,
    sample_seed: int = 123,
    reference: Optional[str] = None,
    crop_seconds: float = 0.0,
    crop_hop_seconds: float = 0.5,
    device: DeviceLike = None,
) -> dict:
    """The session metrics of one crossval JSON, on the trials under
    $NSD_DATA_DIR (the JSON's folds are rebuilt and checked against its
    labels). `reference`: an LSTM checkpoint scored the same way (3
    classes). `device`: CUDA unless named."""
    detail = json.loads(Path(cv_json).read_text())
    fold_detail = detail.get("fold_detail")
    if not fold_detail:
        raise SystemExit(f"{cv_json} has no fold_detail: re-run the crossval tool")
    cfg = detail["config"]
    dev = resolve_device(device)
    disable_tf32()

    n_classes = len(fold_detail[0]["member_nested_probs"][0][0])
    if n_classes == 5:
        ds = load_trials(class_prefixes=FIVE_CLASS_PREFIXES)
        reference = None  # the reference has no 5-class decoder
    else:
        ds = load_trials()
    folds = stratified_folds(ds.labels, detail["folds"], cfg["seed"])
    fcfg = FilterConfig(precision="fast")

    def filter_fn(w):
        return mai_filter_batch(w, fcfg, device=dev)

    ref_probs_fn = None
    if reference is not None:
        filtered = filter_fn(ds.windows)
        lstm_spec = get_model("lstm")
        ref = load_reference(reference, dev)

        @torch.no_grad()
        def ref_probs_fn(idx):
            w = filtered[torch.as_tensor(idx, device=dev)]
            return torch.softmax(lstm_spec.apply(ref, w), -1).cpu().numpy()

    head_fn = featurize_fn = None
    if all("val_features" in fd and "member_nested_params" in fd for fd in fold_detail):
        spec = get_model(detail["model"], **(cfg.get("model_kw") or {}))

        @torch.no_grad()
        def head_fn(p, f):
            f = torch.as_tensor(np.asarray(f, np.float32), device=dev)
            return torch.softmax(spec.head_apply(p, f), dim=-1).cpu().numpy()

        if crop_seconds > 0 and spec.featurize is not None:

            @torch.no_grad()
            def featurize_fn(p, x):
                return spec.featurize(p, x).cpu().numpy()

    rng = np.random.default_rng(sample_seed)
    rows = {
        "ours": [], "ours_featavg": [], "ours_window": [],
        "crop": [], "crop_featavg": [], "crop_window": [],
        "ref": [], "ref_window": [],
    }
    fold_n_per_class = []
    for fold_i, (val_idx, fd) in enumerate(zip(folds, fold_detail)):
        y_val = np.asarray(fd["y_val"])
        if not np.array_equal(ds.labels[val_idx], y_val):
            raise SystemExit(
                f"fold {fold_i}: reconstructed fold labels disagree with "
                f"{cv_json}: dataset or fold seed drifted since the CV run"
            )
        fold_n_per_class.append({int(c): int((y_val == c).sum()) for c in np.unique(y_val)})
        ours = np.mean(np.asarray(fd["member_nested_probs"]), axis=0)
        rows["ours"].append(session_accuracy_from_probs(ours, y_val, n_windows=n_windows, draws=draws, rng=rng))
        rows["ours_window"].append(float((ours.argmax(1) == y_val).mean()))
        if head_fn is not None:
            feats = np.asarray(fd["val_features"], np.float32)
            member_params = [params_from_lists(p, dev) for p in fd["member_nested_params"]]
            rows["ours_featavg"].append(
                session_accuracy_feature_avg(
                    feats, y_val, member_params, head_fn, n_windows=n_windows, draws=draws, rng=rng,
                )
            )
            if featurize_fn is not None:
                cfeats = crop_features(
                    ds.windows[val_idx], member_params, featurize_fn, filter_fn,
                    crop_seconds=crop_seconds, crop_hop_seconds=crop_hop_seconds,
                )
                cprobs = np.mean([head_fn(p, cfeats) for p in member_params], axis=0)
                rows["crop"].append(
                    session_accuracy_from_probs(cprobs, y_val, n_windows=n_windows, draws=draws, rng=rng)
                )
                rows["crop_window"].append(float((cprobs.argmax(1) == y_val).mean()))
                rows["crop_featavg"].append(
                    session_accuracy_feature_avg(
                        cfeats, y_val, member_params, head_fn, n_windows=n_windows, draws=draws, rng=rng,
                    )
                )
        if ref_probs_fn is not None:
            rp = ref_probs_fn(val_idx)
            rows["ref"].append(session_accuracy_from_probs(rp, y_val, n_windows=n_windows, draws=draws, rng=rng))
            rows["ref_window"].append(float((rp.argmax(1) == y_val).mean()))

    def agg(v):
        return {"mean": float(np.mean(v)), "std": float(np.std(v)), "folds": [float(x) for x in v]} if v else None

    return {
        "cv_json": str(cv_json),
        "model": detail["model"],
        "n_windows": n_windows,
        "draws_per_class_per_fold": draws,
        "crop_seconds": crop_seconds if featurize_fn is not None else None,
        "crop_hop_seconds": crop_hop_seconds if featurize_fn is not None else None,
        "session_crop": agg(rows["crop"]),
        "session_crop_feature_avg": agg(rows["crop_featavg"]),
        "per_window_crop": agg(rows["crop_window"]),
        # held-out windows per class per fold: the real sample size behind
        # the resampled draws
        "fold_n_per_class": fold_n_per_class,
        "session": agg(rows["ours"]),
        "session_feature_avg": agg(rows["ours_featavg"]),
        "per_window": agg(rows["ours_window"]),
        "reference_session": agg(rows["ref"]),
        "reference_per_window": agg(rows["ref_window"]),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Session-level accuracy from crossval JSONs (PyTorch port)")
    ap.add_argument("cv_jsons", nargs="+", help="crossval output JSONs")
    ap.add_argument("--windows", type=int, default=10, help="windows per session draw (reference: 10 trials)")
    ap.add_argument("--draws", type=int, default=2000)
    ap.add_argument("--sample-seed", type=int, default=123)
    ap.add_argument("--crop-seconds", type=float, default=0.0,
                    help="test-time time-crop aggregation: average tangent features over overlapping "
                         "sub-windows of this length (0 = off; featurizing families only)")
    ap.add_argument("--crop-hop-seconds", type=float, default=0.5)
    ap.add_argument("--reference", default=None, metavar="PATH",
                    help="a reference LSTM checkpoint (.pth or .npz) scored the same way")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    out = []
    for cv in args.cv_jsons:
        r = evaluate(cv, n_windows=args.windows, draws=args.draws, sample_seed=args.sample_seed,
                     reference=args.reference, crop_seconds=args.crop_seconds,
                     crop_hop_seconds=args.crop_hop_seconds, device=args.device)
        out.append(r)
        s, w = r["session"], r["per_window"]
        print(f"{r['model']} ({Path(cv).name}):")
        print(f"  session ({args.windows}-window avg): {s['mean']:.3f} ± {s['std']:.3f}   "
              f"(per-window {w['mean']:.3f})")
        if r["session_feature_avg"]:
            f = r["session_feature_avg"]
            print(f"  session (feature-space avg):       {f['mean']:.3f} ± {f['std']:.3f}")
        if r["session_crop"]:
            c, cw, cf = r["session_crop"], r["per_window_crop"], r["session_crop_feature_avg"]
            print(f"  session (crop {args.crop_seconds:.1f}s avg):        {c['mean']:.3f} ± {c['std']:.3f}   "
                  f"(per-window {cw['mean']:.3f}; crop+feat-avg {cf['mean']:.3f} ± {cf['std']:.3f})")
        ns = [min(d.values()) for d in r["fold_n_per_class"]]
        print(f"  held-out windows/class/fold (min): {ns}")
        if r["reference_session"]:
            rs, rw = r["reference_session"], r["reference_per_window"]
            print(f"  reference checkpoint:              {rs['mean']:.3f} ± {rs['std']:.3f}   "
                  f"(per-window {rw['mean']:.3f})")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
