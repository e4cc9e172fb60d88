"""Filter-bank log-covariance decoder (tangent-space family), eval path.

Counterpart of neural_speech_decoding_tpu/models/logcov.py. Per window:

  x [B, T, C=8], centred over T
  -> one dense [R, T] cos/sin projection (the filter bank as a matmul;
     the JAX "matmul" spectral method), R = 2 * sum of band bins
  -> per band k the spatial covariance from Parseval,
     S_k = (2/T^2) * sum_{r in band k} y_r y_r^T, shrunk toward
     (tr S_k / C) I; with a fitted whitener W_k folded into the rows,
     W_k S_k W_k^T = (1-a)(2/T^2) gram(Y W_k^T) + a (tr S_k/C + eps) W_k W_k^T
  -> spectrum guard: a Cholesky (Sylvester) test of S/tr - lo I flags the
     bands whose trace-normalised spectrum leaves [lo, hi] and shrinks only
     those back into it
  -> trace-normalised matrix log A = S / (tr/C): logm="rational", a 12-pole
     resolvent sum c0 I + sum_j v_j (A - p_j I)^{-1} by pivot-free
     Gauss-Jordan; logm="chebyshev" (and "chebyshev_scan"), the degree-320
     Chebyshev series of log on [lo, hi] by the matrix Clenshaw recurrence;
     logm="eigh", the eigendecomposition
  -> log(tr/C) on the diagonal, upper triangle row-major with off-diagonals
     weighted by sqrt(2): feature index k * 36 + p
  -> LayerNorm (biased variance) -> linear head.

`logcov_features` dispatches as the JAX package does on the TPU. With a
whitener, spectral="matmul", fused="kernel", the guard on and a rational or
Chebyshev log it takes the kernel route: the gram kernel (ops/kernels/
bandcov.py), then the feature kernel (ops/kernels/logmfeats.py) in the
matching mode. Everything else takes the stages path below, whose grams
(matmul spectral method with a whitener) still go through the gram kernel
and whose logm="chebyshev" goes through the Clenshaw kernel (ops/kernels/
logm.py). Each wrapper launches its CUDA kernel for a CUDA tensor and takes
its plain twin for a CPU tensor. logm="chebyshev_scan" is the plain Clenshaw
recurrence on every device, as in JAX.

Training (JAX models/logcov.py:143-179, 576-612, 705-733):
`init_logcov_params` and `fit_whitener` (the per-band G^-1/2 of the mean
shrunk covariance of the training windows); `logcov_head_apply` drops out
the normalised features in train mode. The whitener is a fitted buffer,
not a weight: the features see it detached, as JAX's stop_gradient. The
kernel route is a torch.autograd.Function whose forward is the two kernels
and whose backward recomputes the features through the differentiable
stages path (`_stages_feats_reference`, as JAX's custom VJP does), with a
zero gradient for the whitener; the gram and Clenshaw wrappers carry their
own backward the same way (ops/kernels/bandcov.py, logm.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.models.stochastic import dropout, require_generator
from neural_speech_decoding_tpu_torch.ops import spd
from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams
from neural_speech_decoding_tpu_torch.ops.kernels.logm import logm_spd_chebyshev
from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import logcov_feats

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LogCovConfig:
    """Fields and defaults of the JAX LogCovConfig (models/logcov.py:38-135):
    spectral "matmul" or "fft"; logm "rational", "chebyshev",
    "chebyshev_scan" or "eigh". An unknown backend raises ValueError when
    used, as in JAX."""

    num_channels: int = 8
    num_classes: int = 3
    sample_rate: int = 125
    bands: Tuple[Tuple[float, float], ...] = (
        (3.0, 8.0),
        (8.0, 13.0),
        (13.0, 30.0),
        (30.0, 48.0),
    )
    shrinkage: float = 0.05
    dropout: float = 0.2
    ln_eps: float = 1e-5
    spectral: str = "matmul"
    whiten: bool = False
    logm: str = "rational"
    logm_terms: int = 12
    cheb_interval: Tuple[float, float] = (0.002, 8.0)
    cheb_degree: int = 320
    guard_domain: bool = True
    fused: str = "kernel"

    def __post_init__(self):
        if self.logm != "eigh" and self.shrinkage < self.cheb_interval[0]:
            raise ValueError(
                f"shrinkage={self.shrinkage} is below the Chebyshev "
                f"interval floor {self.cheb_interval[0]} — the polynomial "
                "logm needs the shrinkage eigenvalue guarantee; raise "
                "shrinkage, widen cheb_interval, or use logm='eigh'"
            )


def _num_features(cfg: LogCovConfig) -> int:
    c = cfg.num_channels
    return len(cfg.bands) * (c * (c + 1)) // 2


def init_logcov_params(generator: torch.Generator, cfg: LogCovConfig) -> Params:
    """LayerNorm scale 1 and bias 0, a normal head scaled by sqrt(1/n), a
    zero head bias (JAX :143-166), and with cfg.whiten the identity
    whitener [nb, C, C] until `fit_whitener` runs; float32 on the
    generator's device."""
    n = _num_features(cfg)
    dev = generator.device
    params = {
        "ln": {"scale": torch.ones(n, device=dev), "bias": torch.zeros(n, device=dev)},
        "head": {
            "w": torch.randn((n, cfg.num_classes), generator=generator, device=dev) * float(np.sqrt(1.0 / n)),
            "b": torch.zeros(cfg.num_classes, device=dev),
        },
    }
    if cfg.whiten:
        eye = torch.eye(cfg.num_channels, device=dev)
        params["whitener"] = eye.expand(len(cfg.bands), -1, -1).contiguous()
    return params


def fit_whitener(params: Params, x_btc, y=None, *, cfg: LogCovConfig) -> Params:
    """The tangent-point whitener G^-1/2 per band, G the mean shrunk band
    covariance of the TRAINING windows x_btc (JAX :169-179), by a float32
    eigendecomposition as JAX takes it. Returns params with "whitener" set;
    the windows go to the device of params' head."""
    dev = params["head"]["w"].device
    x = torch.as_tensor(x_btc, dtype=torch.float32, device=dev)
    with torch.no_grad():
        g = band_covariances(x, cfg).mean(dim=0)  # [nb, C, C]
        w, v = torch.linalg.eigh(g)
        inv_sqrt = torch.matmul(v * (1.0 / torch.sqrt(torch.clamp(w, min=1e-12)))[:, None, :], v.transpose(-1, -2))
    return {**params, "whitener": inv_sqrt.to(torch.float32)}


@functools.lru_cache(maxsize=8)
def _band_projector(t: int, cfg: LogCovConfig):
    """[sum_k 2*bins_k, T] stacked cos/sin DFT rows (built in float64, cast
    to float32) and each band's row slice, as the JAX package builds them."""
    freqs = np.fft.rfftfreq(t, d=1.0 / cfg.sample_rate)
    tt = np.arange(t)
    rows, slices, start = [], [], 0
    for lo, hi in cfg.bands:
        bins = np.flatnonzero((freqs >= lo) & (freqs < hi))
        ang = 2.0 * np.pi * np.outer(bins, tt) / t
        rows.append(np.cos(ang))
        rows.append(np.sin(ang))
        slices.append(slice(start, start + 2 * len(bins)))
        start += 2 * len(bins)
    return np.concatenate(rows).astype(np.float32), tuple(slices)


@functools.lru_cache(maxsize=8)
def _projector_on(t: int, cfg: LogCovConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_projector(t, cfg)[0]).to(device)


@functools.lru_cache(maxsize=8)
def _rational_log_coeffs(
    lo: float, hi: float, terms: int
) -> Tuple[float, Tuple[float, ...], Tuple[float, ...]]:
    """(c0, poles, weights) of log x ~= c0 + sum_j w_j / (x - p_j) on
    [lo, hi]: float64 least squares on a 4000-point log grid, poles
    log-spaced on -[lo/16, 16 hi] (the JAX package's fit, bit for bit)."""
    xs = np.geomspace(lo, hi, 4000)
    poles = -np.geomspace(lo / 16.0, hi * 16.0, terms)
    a = np.concatenate(
        [np.ones((xs.size, 1)), 1.0 / (xs[:, None] - poles[None, :])], axis=1
    )
    coef, *_ = np.linalg.lstsq(a, np.log(xs), rcond=None)
    return (
        float(coef[0]),
        tuple(float(p) for p in poles),
        tuple(float(w) for w in coef[1:]),
    )


@functools.lru_cache(maxsize=8)
def _cheb_log_coeffs(lo: float, hi: float, degree: int) -> Tuple[float, ...]:
    """float64 Chebyshev coefficients of log on [lo, hi] (numpy convention:
    f = sum c_k T_k, c_0 unhalved); the JAX package's fit, bit for bit."""
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(np.log, degree, domain=[lo, hi])
    return tuple(float(c) for c in cheb.coef)


def _fft_band_covariances(x: torch.Tensor, cfg: LogCovConfig) -> list:
    """Per-band covariances from the real FFT by Parseval (JAX
    models/logcov.py:218-229): the band-masked spectrum against the whole
    one, real part, times 2/T^2 (rfft halves the spectrum; the DC bin is
    masked by lo >= 3 Hz and odd T has no Nyquist bin). The bin
    frequencies are float32 k / (T d), as jnp.fft.rfftfreq makes them."""
    t = x.shape[1]
    xf = torch.fft.rfft(x, dim=1)  # [B, F, C] complex
    k = torch.arange(t // 2 + 1, dtype=torch.float32, device=x.device)
    freqs = k / torch.tensor((1.0 / cfg.sample_rate) * t, dtype=torch.float32, device=x.device)
    re, im = xf.real, xf.imag
    covs = []
    for lo, hi in cfg.bands:
        m = ((freqs >= lo) & (freqs < hi)).to(torch.float32)[None, :, None]
        s = torch.matmul((re * m).transpose(1, 2), re) + torch.matmul((im * m).transpose(1, 2), im)
        covs.append(s * (2.0 / (t * t)))
    return covs


def band_covariances(x_btc: torch.Tensor, cfg: LogCovConfig) -> torch.Tensor:
    """[B, T, C] -> shrunk per-band spatial covariances [B, nb, C, C]
    (JAX models/logcov.py:200-237)."""
    t = x_btc.shape[1]
    x = x_btc - x_btc.mean(dim=1, keepdim=True)
    if cfg.spectral == "matmul":
        _, slices = _band_projector(t, cfg)
        y = torch.matmul(_projector_on(t, cfg, x.device), x)  # [B, R, C]
        covs = [
            torch.matmul(y[:, sl].transpose(1, 2), y[:, sl]) * (2.0 / (t * t))
            for sl in slices
        ]
    elif cfg.spectral == "fft":
        covs = _fft_band_covariances(x, cfg)
    else:
        raise ValueError(f"unknown spectral method {cfg.spectral!r}")
    s = torch.stack(covs, dim=1)
    s = 0.5 * (s + s.transpose(-1, -2))
    c = cfg.num_channels
    trace = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return (1.0 - cfg.shrinkage) * s + cfg.shrinkage * (trace / c + 1e-12) * spd.eye_like(s)


def _guard_strength(cfg: LogCovConfig) -> float:
    """g such that (1-g) S + g (tr/C) I is certain to land in [lo, hi]."""
    c = cfg.num_channels
    lo, hi = cfg.cheb_interval
    g = max(cfg.shrinkage, 2.0 * lo)
    if hi < c:
        g = max(g, (c - hi) / (c - 1.0) * 1.001)
    return g


def _logm_spd_rational(s: torch.Tensor, cfg: LogCovConfig) -> torch.Tensor:
    lo, hi = cfg.cheb_interval
    return spd.logm_rational(s, *_rational_log_coeffs(lo, hi, cfg.logm_terms))


def _logm_spd(s: torch.Tensor, cfg: LogCovConfig) -> torch.Tensor:
    """The stages path's matrix log of [B, nb, C, C] (JAX models/logcov.py:
    672-692). logm="chebyshev" goes through the Clenshaw kernel's wrapper
    (the kernel on CUDA, where JAX takes its Pallas kernel on the TPU; the
    twin on the CPU); "chebyshev_scan" is the plain recurrence everywhere."""
    lo, hi = cfg.cheb_interval
    if cfg.logm == "chebyshev":
        return logm_spd_chebyshev(s, _cheb_log_coeffs(lo, hi, cfg.cheb_degree), lo, hi)
    if cfg.logm == "chebyshev_scan":
        return spd.logm_chebyshev(s, _cheb_log_coeffs(lo, hi, cfg.cheb_degree), lo, hi)
    if cfg.logm == "rational":
        return _logm_spd_rational(s, cfg)
    if cfg.logm == "eigh":
        return spd.logm_eigh(s)
    raise ValueError(f"unknown logm backend {cfg.logm!r}")


def domain_flags(s: torch.Tensor, cfg: LogCovConfig) -> torch.Tensor:
    return spd.domain_flags(s, *cfg.cheb_interval)


def guard_spectrum(s: torch.Tensor, cfg: LogCovConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    return spd.guard_spectrum(s, *cfg.cheb_interval, _guard_strength(cfg))


def _project_and_fold_whitener(x_btc: torch.Tensor, cfg: LogCovConfig, w0: torch.Tensor):
    """Centre, band-project, and fold the per-band whitener into the rows:
    (yw [B, R, C] = y W_k^T per band row, y [B, R, C], slices, T). Both
    products are plain matmuls, as the JAX package leaves them to XLA."""
    t = x_btc.shape[1]
    x = x_btc - x_btc.mean(dim=1, keepdim=True)
    _, slices = _band_projector(t, cfg)
    y = torch.matmul(_projector_on(t, cfg, x.device), x)  # [B, R, C]
    yw = torch.cat(
        [torch.matmul(y[:, sl], w0[k].transpose(0, 1)) for k, sl in enumerate(slices)],
        dim=1,
    )
    return yw, y, slices, t


def _band_traces_scaled(y: torch.Tensor, slices, t: int) -> torch.Tensor:
    """[nb, B] per-band tr(G) * 2/T^2 from the unmixed projection rows."""
    sq = torch.sum(y * y, dim=-1)  # [B, R]
    tr = torch.stack([torch.sum(sq[:, sl.start : sl.stop], dim=1) for sl in slices], dim=0)
    return tr * (2.0 / (t * t))


def _wwt(w0: torch.Tensor) -> torch.Tensor:
    return torch.matmul(w0, w0.transpose(-1, -2))  # [nb, C, C]


def _band_offsets(slices) -> Tuple[int, ...]:
    return (slices[0].start,) + tuple(sl.stop for sl in slices)


def _whitened_band_covariances_fused(
    x_btc: torch.Tensor, cfg: LogCovConfig, w0: torch.Tensor
) -> torch.Tensor:
    """Whitened shrunk band covariances [B, nb, C, C] with the whitener
    folded into the projected rows (JAX models/logcov.py:464-504):
    (1-a) (2/T^2) gram(Y W^T) + a (tr G/C + eps) W W^T. The grams go
    through the gram kernel (its twin on the CPU), as the JAX package sends
    them through its Pallas kernel on the TPU."""
    c = cfg.num_channels
    yw, y, slices, t = _project_and_fold_whitener(x_btc, cfg, w0)
    pairs = band_grams(yw.contiguous(), _band_offsets(slices))
    g_w = spd.pairs_to_matrix(pairs.reshape(pairs.shape[0], len(slices), -1), c)
    g_w = g_w * (2.0 / (t * t))
    tr_g = _band_traces_scaled(y, slices, t).T  # [B, nb]
    return (1.0 - cfg.shrinkage) * g_w + cfg.shrinkage * (
        tr_g[..., None, None] / c + 1e-12
    ) * _wwt(w0)[None]


class KernelInputs(NamedTuple):
    """What the kernel route hands its two kernels."""

    yw: torch.Tensor  # [B, R, C] whitened projection rows (gram kernel)
    offsets: Tuple[int, ...]  # nb + 1 band row offsets
    tr_scaled: torch.Tensor  # [B, nb] per-band tr(G) 2/T^2
    wwt_pairs: torch.Tensor  # [nb, P] upper-triangle pairs of W_k W_k^T
    coeffs: Tuple[float, ...]  # rational: c0, poles, weights; chebyshev: c_0..c_degree
    scalars: Dict[str, Any]  # the feature kernel's keywords: scale, alpha, lo, hi, guard_g, logm


def kernel_inputs(x_btc: torch.Tensor, w0: torch.Tensor, cfg: LogCovConfig) -> KernelInputs:
    """The prefix of the kernel route (JAX _fused_kernel_forward,
    models/logcov.py:507-556): project, fold the whitener, traces and
    W W^T pairs, all plain PyTorch, and the coefficients of the log."""
    yw, y, slices, t = _project_and_fold_whitener(x_btc, cfg, w0)
    iu, ju = torch.triu_indices(cfg.num_channels, cfg.num_channels, device=w0.device)
    lo, hi = cfg.cheb_interval
    if cfg.logm == "rational":
        c0, poles, weights = _rational_log_coeffs(lo, hi, cfg.logm_terms)
        coeffs = (c0,) + poles + weights
    else:
        coeffs = _cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    return KernelInputs(
        yw=yw.contiguous(),
        offsets=_band_offsets(slices),
        tr_scaled=_band_traces_scaled(y, slices, t).T.contiguous(),
        wwt_pairs=_wwt(w0)[:, iu, ju].contiguous(),
        coeffs=coeffs,
        scalars=dict(
            scale=2.0 / (t * t), alpha=cfg.shrinkage, lo=lo, hi=hi,
            guard_g=_guard_strength(cfg), logm=cfg.logm,
        ),
    )


def _kernel_route(x_btc: torch.Tensor, w0: torch.Tensor, cfg: LogCovConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route's forward: band-gram pair rows [B, nb*36] from the
    gram kernel, then shrinkage, guard, rational or Chebyshev logm and triu
    features in the feature kernel. Returns (feats [B, nb*36], flags [B]
    bool). On a CPU tensor the two wrappers take their plain twins."""
    k = kernel_inputs(x_btc, w0, cfg)
    grams = band_grams(k.yw, k.offsets)
    feats, band_flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    return feats, band_flags.any(dim=1)


def _stages_feats_reference(x_btc: torch.Tensor, w0: torch.Tensor, cfg: LogCovConfig) -> torch.Tensor:
    """The same features through the differentiable stages path (JAX
    :576-591): whitened covariances, guard, the plain rational or Chebyshev
    log, weighted triu. The kernel route's backward recomputes through it."""
    s = _whitened_band_covariances_fused(x_btc, cfg, w0)
    s, _ = guard_spectrum(s, cfg)
    if cfg.logm == "rational":
        logm = _logm_spd_rational(s, cfg)
    else:
        lo, hi = cfg.cheb_interval
        logm = spd.logm_chebyshev(s, _cheb_log_coeffs(lo, hi, cfg.cheb_degree), lo, hi)
    return spd.triu_features(logm)


class _KernelRouteFeats(torch.autograd.Function):
    """The kernel route with JAX's custom VJP (:594-612): the forward is
    the two kernels; the backward recomputes the features from the saved
    windows through `_stages_feats_reference` under autograd and pulls the
    cotangent back through it. The flags are not differentiable, and the
    whitener (a fitted buffer) gets a zero gradient."""

    @staticmethod
    def forward(ctx, x_btc, w0, cfg):
        ctx.save_for_backward(x_btc, w0)
        ctx.cfg = cfg
        feats, flags = _kernel_route(x_btc, w0, cfg)
        ctx.mark_non_differentiable(flags)
        return feats, flags

    @staticmethod
    def backward(ctx, g_feats, g_flags):
        x_btc, w0 = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                x = x_btc.detach().requires_grad_(True)
                feats = _stages_feats_reference(x, w0.detach(), ctx.cfg)
                (dx,) = torch.autograd.grad(feats, x, g_feats)
        dw = torch.zeros_like(w0) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _fused_kernel_feats(
    x_btc: torch.Tensor, w0: torch.Tensor, cfg: LogCovConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route, differentiable in x_btc: (feats [B, nb*36],
    flags [B] bool)."""
    return _KernelRouteFeats.apply(x_btc, w0, cfg)


def logcov_features(
    x_btc: torch.Tensor,
    cfg: LogCovConfig,
    whitener: Optional[torch.Tensor] = None,
    *,
    with_flags: bool = False,
):
    """[B, T, C] -> tangent-space features [B, n_features] (and, with
    `with_flags`, the per-window guard flags [B] bool). Dispatch as JAX
    models/logcov.py:615-700 does on the TPU."""
    x = x_btc.to(torch.float32)
    if whitener is not None:
        # a fitted buffer, not a weight (JAX: stop_gradient)
        whitener = whitener.detach()
    if whitener is not None and cfg.spectral == "matmul":
        w0 = whitener.to(device=x.device, dtype=torch.float32)
        if cfg.fused == "kernel" and cfg.logm in ("chebyshev", "rational") and cfg.guard_domain:
            feats, flags = _fused_kernel_feats(x, w0, cfg)
            return (feats, flags) if with_flags else feats
        s = _whitened_band_covariances_fused(x, cfg, w0)
    elif whitener is not None:
        w0 = whitener.to(device=x.device, dtype=torch.float32)
        s = torch.matmul(torch.matmul(w0, band_covariances(x, cfg)), w0)  # W S W per band
        s = 0.5 * (s + s.transpose(-1, -2))
    else:
        s = band_covariances(x, cfg)
    # The shrinkage floor guarantees the domain for unwhitened covariances
    # under the default interval; whitening, or hi < C, does not. Only the
    # polynomial logs extrapolate; eigh degrades boundedly on its own.
    flags = None
    polynomial = cfg.logm in ("chebyshev", "chebyshev_scan", "rational")
    at_risk = whitener is not None or cfg.cheb_interval[1] < cfg.num_channels
    if cfg.guard_domain and polynomial and at_risk:
        s, band_flags = guard_spectrum(s, cfg)
        flags = band_flags.any(dim=-1)
    elif with_flags:
        flags = (
            domain_flags(s, cfg).any(dim=-1)
            if at_risk
            else torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
        )
    feats = spd.triu_features(_logm_spd(s, cfg))
    if with_flags:
        return feats, flags
    return feats


def logcov_head_apply(
    params: Params,
    feats: torch.Tensor,
    cfg: LogCovConfig = LogCovConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """LayerNorm + dropout (train mode, a mask from `generator`) + linear
    head on precomputed features -> logits [B, num_classes]."""
    require_generator(train, generator)
    mean = feats.mean(dim=-1, keepdim=True)
    var = torch.square(feats - mean).mean(dim=-1, keepdim=True)  # biased
    f = (feats - mean) / torch.sqrt(var + cfg.ln_eps)
    f = f * params["ln"]["scale"] + params["ln"]["bias"]
    if train:
        f = dropout(f, cfg.dropout, generator)
    return f @ params["head"]["w"] + params["head"]["b"]


def logcov_apply_ex(
    params: Params,
    x_btc: torch.Tensor,
    cfg: LogCovConfig = LogCovConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits [B, classes], {"domain_flags": [B] bool}).
    Whitening keys off the checkpoint: params holding a "whitener" are
    always served whitened, whatever cfg.whiten says."""
    require_generator(train, generator)
    feats, flags = logcov_features(x_btc, cfg, whitener=params.get("whitener"), with_flags=True)
    logits = logcov_head_apply(params, feats, cfg, train=train, generator=generator)
    return logits, {"domain_flags": flags}


def logcov_apply(
    params: Params,
    x_btc: torch.Tensor,
    cfg: LogCovConfig = LogCovConfig(),
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    return logcov_apply_ex(params, x_btc, cfg, train=train, generator=generator)[0]
