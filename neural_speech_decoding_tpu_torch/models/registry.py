"""Model registry: every decoder family of the JAX registry, by name.

Counterpart of neural_speech_decoding_tpu/models/registry.py:33-290: the
LSTM ("lstm", "lstm5"), EEGNet ("eegnet", "eegnet5"), the transformer
("transformer", "transformer5"), the TCN ("tcn", "tcn5", "tcn_small",
"tcn_wide"), the LRU ("lru", "lru5") and the log-covariance family
("logcov", "logcov5", "logcov8", "logcov12", "logcov8_5", "logcov12_5").
A ModelSpec carries the family's config and class names and

  init(generator) -> params (float32 tensors on the generator's device)
  apply(params, x_btc, *, train=False, generator=None) -> logits [B, classes]

and a logcov spec also

  fit(params, x_train, y_train) -> params with the fitted whitener
      (whiten=True only; training windows only, never evaluation data)
  apply_ex(params, x_btc, *, train, generator) -> (logits, {"domain_flags": [B] bool})
  featurize(params, x_btc) -> feats, parameter-free (the whitener is a
      fitted buffer), so training runs in head space after one featurize
  featurize_ex(params, x_btc) -> (feats, flags)
  head_apply(params, feats, *, train, generator) -> logits

apply == head_apply(featurize(...)). Train mode draws its randomness from
`generator`. The engines serve the LSTM through models/lstm.decoder_logits
with the pipeline's decoder config, which may differ from the spec's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

from neural_speech_decoding_tpu_torch.config import (
    FIVE_CLASS_NAMES,
    THREE_CLASS_NAMES,
    DecoderConfig,
)
from neural_speech_decoding_tpu_torch.models import eegnet as _eegnet
from neural_speech_decoding_tpu_torch.models import logcov as _logcov
from neural_speech_decoding_tpu_torch.models import lru as _lru
from neural_speech_decoding_tpu_torch.models import lstm as _lstm
from neural_speech_decoding_tpu_torch.models import tcn as _tcn
from neural_speech_decoding_tpu_torch.models import transformer as _transformer


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    config: Any
    class_names: Tuple[str, ...]
    init: Callable[..., Any]
    apply: Callable[..., Any]
    fit: Optional[Callable[..., Any]] = None
    apply_ex: Optional[Callable[..., Any]] = None
    featurize: Optional[Callable[..., Any]] = None
    featurize_ex: Optional[Callable[..., Any]] = None
    head_apply: Optional[Callable[..., Any]] = None


def _plain_spec(config_cls, init_fn, apply_fn) -> Callable[..., ModelSpec]:
    """Spec factory of a family whose spec has only `init` and `apply`: the
    LSTM, EEGNet, the TCN, the transformer and the LRU."""

    def make(name: str, num_classes: int, class_names, **cfg_kw) -> ModelSpec:
        cfg = config_cls(num_classes=num_classes, **cfg_kw)
        return ModelSpec(
            name=name,
            config=cfg,
            class_names=tuple(class_names),
            init=lambda generator: init_fn(generator, cfg),
            apply=lambda p, x, *, train=False, generator=None: apply_fn(
                p, x, cfg, train=train, generator=generator
            ),
        )

    return make


_lstm_spec = _plain_spec(DecoderConfig, _lstm.init_decoder_params, _lstm.decoder_apply)
_eegnet_spec = _plain_spec(_eegnet.EEGNetConfig, _eegnet.init_eegnet_params, _eegnet.eegnet_apply)
_tcn_spec = _plain_spec(_tcn.TCNConfig, _tcn.init_tcn_params, _tcn.tcn_apply)
_transformer_spec = _plain_spec(
    _transformer.TransformerConfig, _transformer.init_transformer_params, _transformer.transformer_apply
)
_lru_spec = _plain_spec(_lru.LRUConfig, _lru.init_lru_params, _lru.lru_apply)


def _logcov_spec(name: str, num_classes: int, class_names, **cfg_kw) -> ModelSpec:
    cfg = _logcov.LogCovConfig(num_classes=num_classes, **cfg_kw)
    return ModelSpec(
        name=name,
        config=cfg,
        class_names=tuple(class_names),
        init=lambda generator: _logcov.init_logcov_params(generator, cfg),
        apply=lambda p, x, *, train=False, generator=None: _logcov.logcov_apply(
            p, x, cfg, train=train, generator=generator
        ),
        fit=(lambda p, x, y=None: _logcov.fit_whitener(p, x, y, cfg=cfg)) if cfg.whiten else None,
        apply_ex=lambda p, x, *, train=False, generator=None: _logcov.logcov_apply_ex(
            p, x, cfg, train=train, generator=generator
        ),
        featurize=lambda p, x: _logcov.logcov_features(x, cfg, whitener=p.get("whitener")),
        featurize_ex=lambda p, x: _logcov.logcov_features(
            x, cfg, whitener=p.get("whitener"), with_flags=True
        ),
        head_apply=lambda p, f, *, train=False, generator=None: _logcov.logcov_head_apply(
            p, f, cfg, train=train, generator=generator
        ),
    )


_NARROW_BANDS = (
    (3.0, 6.0), (6.0, 9.0), (9.0, 13.0), (13.0, 18.0),
    (18.0, 24.0), (24.0, 32.0), (32.0, 40.0), (40.0, 48.0),
)
_BROAD_BANDS = _logcov.LogCovConfig().bands

_FAMILIES: Dict[str, Callable[..., ModelSpec]] = {
    "lstm": lambda **kw: _lstm_spec("lstm", 3, THREE_CLASS_NAMES, **kw),
    "lstm5": lambda **kw: _lstm_spec("lstm5", 5, FIVE_CLASS_NAMES, **kw),
    "eegnet": lambda **kw: _eegnet_spec("eegnet", 3, THREE_CLASS_NAMES, **kw),
    "eegnet5": lambda **kw: _eegnet_spec("eegnet5", 5, FIVE_CLASS_NAMES, **kw),
    "transformer": lambda **kw: _transformer_spec("transformer", 3, THREE_CLASS_NAMES, **kw),
    "transformer5": lambda **kw: _transformer_spec("transformer5", 5, FIVE_CLASS_NAMES, **kw),
    "tcn": lambda **kw: _tcn_spec("tcn", 3, THREE_CLASS_NAMES, **kw),
    "tcn5": lambda **kw: _tcn_spec("tcn5", 5, FIVE_CLASS_NAMES, **kw),
    "lru": lambda **kw: _lru_spec("lru", 3, THREE_CLASS_NAMES, **kw),
    "lru5": lambda **kw: _lru_spec("lru5", 5, FIVE_CLASS_NAMES, **kw),
    # capacity variants: a small, harder-regularised stack and a wide one
    "tcn_small": lambda **kw: _tcn_spec(
        "tcn_small", 3, THREE_CLASS_NAMES, **{"width": 32, "blocks": 4, "dropout": 0.45, **kw}
    ),
    "tcn_wide": lambda **kw: _tcn_spec(
        "tcn_wide", 3, THREE_CLASS_NAMES, **{"width": 64, "dropout": 0.4, **kw}
    ),
    "logcov": lambda **kw: _logcov_spec("logcov", 3, THREE_CLASS_NAMES, **kw),
    "logcov5": lambda **kw: _logcov_spec("logcov5", 5, FIVE_CLASS_NAMES, **kw),
    "logcov8": lambda **kw: _logcov_spec(
        "logcov8", 3, THREE_CLASS_NAMES, **{"bands": _NARROW_BANDS, **kw}
    ),
    "logcov12": lambda **kw: _logcov_spec(
        "logcov12", 3, THREE_CLASS_NAMES, **{"bands": _BROAD_BANDS + _NARROW_BANDS, **kw}
    ),
    "logcov8_5": lambda **kw: _logcov_spec(
        "logcov8_5", 5, FIVE_CLASS_NAMES, **{"bands": _NARROW_BANDS, **kw}
    ),
    "logcov12_5": lambda **kw: _logcov_spec(
        "logcov12_5", 5, FIVE_CLASS_NAMES, **{"bands": _BROAD_BANDS + _NARROW_BANDS, **kw}
    ),
}

def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def parse_model_kw(pairs) -> Dict[str, Any]:
    """CLI "--model-kw KEY=VALUE" strings -> config-override dict: values
    parse as JSON (falling back to the string), dashes become underscores."""
    kw: Dict[str, Any] = {}
    for pair in pairs:
        key, eq, raw = pair.partition("=")
        if not eq:
            raise SystemExit(f"--model-kw expects KEY=VALUE, got {pair!r}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        kw[key.replace("-", "_")] = val
    return kw


def family_model_kw(model_kw, name: str) -> Dict[str, Any]:
    """Per-family overrides: "logcov8_5:whiten=true" applies only to that
    family; unprefixed keys apply to every family."""
    kw: Dict[str, Any] = {}
    for k, v in (model_kw or {}).items():
        fam, sep, sub = k.partition(":")
        if sep:
            if fam == name:
                kw[sub] = v
        else:
            kw[k] = v
    return kw


def _freeze(value: Any) -> Any:
    """JSON-decoded override values -> hashable (lists become tuples)."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


def get_model(name: str, **cfg_kw: Any) -> ModelSpec:
    """Resolve a family, optionally overriding config fields
    (get_model("logcov8", whiten=True)); overrides win over the entry's
    own defaults, and lists are frozen to tuples."""
    try:
        make = _FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {', '.join(available_models())}"
        ) from None
    return make(**{k: _freeze(v) for k, v in cfg_kw.items()})
