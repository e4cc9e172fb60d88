"""Ensemble inference: K checkpoints decoded in one pass.

Counterpart of neural_speech_decoding_tpu/runtime/ensemble.py. The
accuracy flagship is a seed ensemble: K models trained from different
seeds whose softmax probabilities are averaged. The MAI filter runs once
per window (it is model-independent); then the members decode in groups,
one group per family:

  * logcov members whose whitener buffers are identical (seed ensembles,
    whose whitener is fitted on the same training data) share one
    feature extraction: the band grams and the matrix logs run once, and
    only the K LayerNorm + linear heads run per member, batched over the
    stacked parameters;
  * other logcov groups run each member's features and head, and OR the
    members' guard flags;
  * LSTM groups run one decoder per member, and the other families
    (EEGNet, TCN, transformer, LRU) each member's `apply`.

A single-family ensemble is one group. A mixed-family one ("logcov8+tcn",
k members per family in family order, or an explicit `families=` list
parallel to the members, with per-family overrides "fam:key" in
`model_kw`) keeps its groups in first-seen order. The softmaxes of all
members of all groups are combined at once, by mean (the deployed
default) or by the renormalised per-class median; guard flags are OR'd
over the groups. The JAX engine's mesh, member sharding and bf16 turbo
options are still to port (ROADMAP.md).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FilterConfig, PipelineConfig
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
from neural_speech_decoding_tpu_torch.models.registry import family_model_kw, get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.engine import (
    _disable_tf32,
    _serving_config,
    _ServingBase,
    load_params,
)
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(_structure(v) for v in tree))
    return "leaf"


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        return tuple(_leaf_shapes(tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_leaf_shapes(v) for v in tree)
    return tuple(np.shape(tree))


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack([np.asarray(t, dtype=np.float32) for t in trees])


def stack_params(members: Sequence) -> object:
    """Stack K structurally identical parameter pytrees along a new leading
    axis (numpy float32 leaves). Raises if the members disagree in
    structure or leaf shapes."""
    if not members:
        raise ValueError("need at least one ensemble member")
    structures = {_structure(m) for m in members}
    if len(structures) != 1:
        raise ValueError(f"ensemble members differ in structure: {structures}")
    if len({_leaf_shapes(m) for m in members}) != 1:
        raise ValueError("ensemble members differ in leaf shapes")
    return _stack(list(members))


def _combine_soft(soft: torch.Tensor, how: str) -> torch.Tensor:
    """[K, B, C] member softmaxes -> [B, C]. "median" renormalises (the
    per-class median of simplex points is not on the simplex). For an
    even K the median is the mean of the two middle values, as jnp.median
    and np.median take it (torch.median would take the lower one)."""
    if how == "median":
        k = soft.shape[0]
        srt = torch.sort(soft, dim=0).values
        med = srt[k // 2] if k % 2 else 0.5 * (srt[k // 2 - 1] + srt[k // 2])
        return med / med.sum(dim=-1, keepdim=True)
    return soft.mean(dim=0)


def _identical_whiteners(params_list) -> bool:
    """True when every member's whitener buffer is identical, or absent
    everywhere: then the feature extractor is the same function of the
    input for all members."""
    if not all(isinstance(p, dict) for p in params_list):
        return False
    ws = [p.get("whitener") for p in params_list]
    if all(w is None for w in ws):
        return True
    if all(w is not None for w in ws):
        w0 = np.asarray(ws[0])
        return all(np.array_equal(np.asarray(w), w0) for w in ws[1:])
    return False


class _Group:
    """The members of one family: their parameters on the device, one by
    one and stacked, and how they decode filtered windows."""

    def __init__(self, spec, params_list, device, share_features: str, decoder_config):
        self.spec = spec
        self.is_lstm = spec.name.startswith("lstm")
        self.decoder_config = decoder_config  # the LSTM's, else unused
        self.stacked = params_from_jax(stack_params(params_list), device)
        self.members = [params_from_jax(p, device) for p in params_list]
        self.has_aux = not self.is_lstm and spec.apply_ex is not None
        self.shared = (
            share_features == "auto"
            and self.has_aux
            and spec.featurize_ex is not None
            and spec.head_apply is not None
            and len(params_list) > 1
            and _identical_whiteners(params_list)
        )

    def featurize(self, filtered: torch.Tensor):
        return self.spec.featurize_ex(self.members[0], filtered)

    def heads(self, feats: torch.Tensor) -> torch.Tensor:
        head = self.spec.head_apply
        return torch.func.vmap(lambda p: head(p, feats))(
            {"ln": self.stacked["ln"], "head": self.stacked["head"]}
        )

    def forward(self, filtered: torch.Tensor):
        """Filtered windows -> (member logits [k, B, classes], flags [B] or
        None)."""
        if self.shared:
            feats, flags = self.featurize(filtered)
            return self.heads(feats), flags
        if self.has_aux:
            outs = [self.spec.apply_ex(p, filtered) for p in self.members]
            flags = torch.stack([aux["domain_flags"] for _, aux in outs]).any(dim=0)
            return torch.stack([logits for logits, _ in outs]), flags
        if self.is_lstm:
            return torch.stack([decoder_logits(p, filtered, self.decoder_config) for p in self.members]), None
        return torch.stack([self.spec.apply(p, filtered) for p in self.members]), None


class EnsembleEngine(_ServingBase):
    """Same predict surface as InferenceEngine, over K checkpoints of one
    family or of several; `logits_batch` returns the member logits
    [K, B, classes], in group order."""

    def __init__(
        self,
        model_paths: Optional[Sequence[str]] = None,
        *,
        params_list: Optional[Sequence] = None,
        model: str = "lstm",
        config: Optional[PipelineConfig] = None,
        class_names: Optional[Sequence[str]] = None,
        turbo: bool = False,
        model_kw: Optional[dict] = None,
        mesh=None,
        shard_members: bool = False,
        share_features: str = "auto",
        families: Optional[Sequence[str]] = None,
        combine: str = "mean",
        device: DeviceLike = None,
    ):
        """`model` names one family, or a mix "famA+famB" whose members
        split evenly in that order; `families` (parallel to the members)
        names each member's family instead. `share_features="auto"`
        extracts logcov features once per group whose whiteners are
        identical; "never" forces the per-member pipeline. `combine` is
        "mean" or "median"."""
        if combine not in ("mean", "median"):
            raise ValueError(f"unknown combine {combine!r}")
        fam_names = [f.strip() for f in model.split("+") if f.strip()]
        mixed = len(fam_names) > 1 or families is not None
        if mixed and (turbo or shard_members):
            raise ValueError("turbo/shard_members are not supported for mixed-family ensembles")
        if turbo or mesh is not None or shard_members:
            raise NotImplementedError(
                "turbo, mesh and shard_members are not ported yet (ROADMAP.md: mesh/turbo serving)"
            )
        self.combine = combine
        self.device = resolve_device(device)
        _disable_tf32()
        if params_list is None:
            if not model_paths:
                raise ValueError("need model_paths or params_list")
            params_list = [load_params(p, model) for p in model_paths]
        self.num_members = len(params_list)
        if mixed:
            self._init_mixed(params_list, fam_names, families, config, model_kw, share_features)
        else:
            spec = get_model(model, **(model_kw or {}))
            self._spec = spec
            self.config = config or _serving_config(spec, model)
            group = _Group(spec, params_list, self.device, share_features, self.config.decoder)
            self._groups = (group,)
            self.params = group.stacked
            self._shared_featurize = group.shared
        self.class_names = tuple(class_names or self.config.class_names)
        self._has_aux = any(g.has_aux for g in self._groups)
        self._init_serving()

    def _init_mixed(self, params_list, fam_names, families, config, model_kw, share_features) -> None:
        """Cross-family groups: one per family, in first-seen order, each
        with its own overrides (registry.family_model_kw)."""
        if families is None:
            if not fam_names:
                raise ValueError("need a model string or explicit families")
            k, rem = divmod(len(params_list), len(fam_names))
            if rem or k == 0:
                raise ValueError(
                    f"{len(params_list)} members do not split evenly over "
                    f"families {fam_names}; pass families= explicitly"
                )
            families = [f for f in fam_names for _ in range(k)]
        families = [str(f) for f in families]
        if len(families) != len(params_list):
            raise ValueError(
                f"families ({len(families)}) must parallel members ({len(params_list)})"
            )
        self.families = tuple(families)
        specs = {fam: get_model(fam, **family_model_kw(model_kw, fam)) for fam in dict.fromkeys(families)}
        name_sets = {spec.class_names for spec in specs.values()}
        if len(name_sets) != 1:
            raise ValueError(f"mixed-family members disagree on class names: {name_sets}")
        spec0 = next(iter(specs.values()))
        self.config = config or PipelineConfig(
            class_names=spec0.class_names, filter=FilterConfig(precision="fast")
        )
        self._groups = tuple(
            _Group(
                spec,
                [p for p, f in zip(params_list, families) if f == fam],
                self.device,
                share_features,
                spec.config,
            )
            for fam, spec in specs.items()
        )
        self.params = tuple(g.stacked for g in self._groups)
        self._shared_featurize = tuple(g.shared for g in self._groups)

    def _forward(self, windows_btc: torch.Tensor):
        filtered = mai_filter_batch(windows_btc, self.config.filter, device=self.device)
        return self._decode_filtered(filtered)

    def _decode_filtered(self, filtered: torch.Tensor):
        """Filtered windows -> (member logits [K, B, classes], flags [B] or
        None): flags are OR'd over the groups that have them, and all
        False when a group has a guard but none flagged a window."""
        outs = [g.forward(filtered) for g in self._groups]
        logits = outs[0][0] if len(outs) == 1 else torch.cat([lg for lg, _ in outs])
        flags = None
        for _, f in outs:
            if f is not None:
                flags = f if flags is None else flags | f
        if flags is None and self._has_aux:
            flags = torch.zeros(filtered.shape[0], dtype=torch.bool, device=filtered.device)
        return logits, flags

    def featurize(self, filtered: torch.Tensor):
        """The shared feature extraction of a single-family logcov
        ensemble: (feats [B, F], flags [B])."""
        return self._groups[0].featurize(filtered)

    def heads(self, feats: torch.Tensor) -> torch.Tensor:
        """Every member's head of a single-family logcov ensemble on shared
        features, in one pass over the stacked parameters:
        [K, B, classes]."""
        return self._groups[0].heads(feats)

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        return _combine_soft(torch.softmax(logits, dim=-1), self.combine)

    @classmethod
    def from_manifest(cls, manifest_path: str, **kw) -> "EnsembleEngine":
        """Build from a fit_ensemble manifest JSON. Member paths resolve
        relative to the manifest's directory, then by basename next to it
        (the manifests record repository-root paths)."""
        mpath = Path(manifest_path)
        manifest = json.loads(mpath.read_text())
        members = []
        for p in manifest["members"]:
            cand = Path(p)
            if not cand.is_absolute():
                rel = mpath.parent / cand
                cand = rel if rel.exists() else mpath.parent / cand.name
            members.append(str(cand))
        if len(set(members)) != len(members):
            raise ValueError(f"manifest members collapse to duplicate paths: {members}")
        kw.setdefault("model", manifest.get("model", "lstm"))
        kw.setdefault("model_kw", manifest.get("config", {}).get("model_kw") or None)
        if manifest.get("families"):
            kw.setdefault("families", manifest["families"])
        if kw["model"] == "lstm":
            # reference class-name quirk: every lstm serving path labels
            # class 2 "None"
            kw.setdefault("class_names", ("Food", "Water", "None"))
        return cls(members, **kw)
