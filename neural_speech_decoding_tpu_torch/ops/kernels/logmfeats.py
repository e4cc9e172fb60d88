"""Fused whitened log-covariance features (rational or Chebyshev matrix
log): CUDA kernel and plain twin.

Replaces the Pallas TPU kernel neural_speech_decoding_tpu/ops/pallas/
logmfeats.py:63 (_fused_kernel, grid call _fused_batched:320, wrapper
fused_whitened_logcov_feature_rows:344) in both its modes. From the
band-gram pairs of ops/kernels/bandcov.py it computes, per window and band:
the shrinkage combine, the spectrum guard (flags where it fires), the
trace-normalised matrix log (logm="rational": the 12-pole resolvent sum;
logm="chebyshev": the Chebyshev series by the Clenshaw recurrence, :239-275)
and the sqrt(2)-weighted upper-triangle features. The kernel
(csrc/logcov_feats.cu, plain nvcc, ctypes) runs for a CUDA tensor, its two
modes counted apart (logcov_feats, logcov_feats_chebyshev); the plain twin,
the stages arithmetic of ops/spd.py on the same inputs, for a CPU tensor
and as the kernel's test oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from neural_speech_decoding_tpu_torch.ops import kernels, spd
from neural_speech_decoding_tpu_torch.ops.kernels import build
from neural_speech_decoding_tpu_torch.ops.kernels.logm import device_coeffs

NAME = "logcov_feats"
CHEB_NAME = "logcov_feats_chebyshev"
MODES = ("rational", "chebyshev")
CHANNELS = 8
PAIRS = CHANNELS * (CHANNELS + 1) // 2


def _split_coeffs(coeffs: Sequence[float]) -> Tuple[float, Tuple[float, ...], Tuple[float, ...]]:
    """(c0, p_0..p_{M-1}, v_0..v_{M-1}) -> (c0, poles, weights)."""
    terms = (len(coeffs) - 1) // 2
    if terms < 1 or len(coeffs) != 1 + 2 * terms:
        raise ValueError(f"expected c0, M poles and M weights, got {len(coeffs)} coefficients")
    return float(coeffs[0]), tuple(coeffs[1 : 1 + terms]), tuple(coeffs[1 + terms :])


def logcov_feats_plain(
    grams: torch.Tensor,
    tr_scaled: torch.Tensor,
    wwt_pairs: torch.Tensor,
    coeffs: Sequence[float],
    *,
    scale: float,
    alpha: float,
    lo: float,
    hi: float,
    guard_g: float,
    logm: str = "rational",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version on [..., 8, 8] matrices: shrink, guard,
    rational or Chebyshev logm, weighted triu. Any float dtype: in float64
    it is the kernel's accuracy reference."""
    _check_mode(logm)
    b, nb = tr_scaled.shape
    g = spd.pairs_to_matrix(grams.reshape(b, nb, PAIRS), CHANNELS)
    w = spd.pairs_to_matrix(wwt_pairs, CHANNELS)
    s = (1.0 - alpha) * (g * scale) + alpha * (tr_scaled[..., None, None] / CHANNELS + 1e-12) * w
    s, flags = spd.guard_spectrum(s, lo, hi, guard_g)
    if logm == "chebyshev":
        return spd.triu_features(spd.logm_chebyshev(s, coeffs, lo, hi)), flags
    return spd.triu_features(spd.logm_rational(s, *_split_coeffs(coeffs))), flags


@functools.lru_cache(maxsize=16)
def _rational_args(coeffs: Tuple[float, ...]) -> Tuple[ctypes.Array, int]:
    """(c0, poles, weights) as the launch's float64 array and the pole
    count, built once per coefficient set: a launch at B = 1024 costs less
    on the card than the host work around it."""
    c0, poles, weights = _split_coeffs(coeffs)
    return (ctypes.c_double * len(coeffs))(c0, *poles, *weights), len(poles)


def _check_mode(logm: str) -> None:
    if logm not in MODES:
        raise ValueError(f"unknown feature kernel mode {logm!r}; expected one of {MODES}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(NAME)
    lib.nsd_logcov_feats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p,
    ]
    lib.nsd_logcov_feats.restype = ctypes.c_int
    lib.nsd_logcov_feats_max_terms.argtypes = []
    lib.nsd_logcov_feats_max_terms.restype = ctypes.c_int
    lib.nsd_logcov_feats_chebyshev.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p,
    ]
    lib.nsd_logcov_feats_chebyshev.restype = ctypes.c_int
    lib.nsd_logcov_feats_max_degree.argtypes = []
    lib.nsd_logcov_feats_max_degree.restype = ctypes.c_int
    lib.nsd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nsd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(grams: torch.Tensor, tr_scaled: torch.Tensor, wwt_pairs: torch.Tensor) -> None:
    for name, t in (("grams", grams), ("tr_scaled", tr_scaled), ("wwt_pairs", wwt_pairs)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.device != grams.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported or mixed device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 2-d tensor, got {tuple(t.shape)}")
    b, nb = tr_scaled.shape
    if grams.shape != (b, nb * PAIRS) or wwt_pairs.shape != (nb, PAIRS) or nb < 1:
        raise ValueError(
            f"expected grams [B, nb*{PAIRS}], tr_scaled [B, nb], wwt_pairs [nb, {PAIRS}]; got "
            f"{tuple(grams.shape)}, {tuple(tr_scaled.shape)}, {tuple(wwt_pairs.shape)}"
        )


def logcov_feats(
    grams: torch.Tensor,
    tr_scaled: torch.Tensor,
    wwt_pairs: torch.Tensor,
    coeffs: Sequence[float],
    *,
    scale: float,
    alpha: float,
    lo: float,
    hi: float,
    guard_g: float,
    logm: str = "rational",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band-gram pairs [B, nb*36] (unscaled), per-band tr(G) 2/T^2 [B, nb],
    W W^T pairs [nb, 36] and the coefficients of the log (logm="rational":
    c0, poles, weights; logm="chebyshev": c_0..c_degree on [lo, hi]) ->
    (feats [B, nb*36] float32, flags [B, nb] bool). Launches the CUDA
    kernel in that mode for a CUDA tensor (and counts the launch under the
    mode's name); takes the plain twin for a CPU tensor."""
    _check(grams, tr_scaled, wwt_pairs)
    _check_mode(logm)
    kw = dict(scale=scale, alpha=alpha, lo=lo, hi=hi, guard_g=guard_g)
    if logm == "rational":
        cbuf, terms = _rational_args(tuple(float(c) for c in coeffs))
    elif len(coeffs) < 1:
        raise ValueError("expected at least one Chebyshev coefficient")
    if grams.device.type == "cpu":
        return logcov_feats_plain(grams, tr_scaled, wwt_pairs, coeffs, **kw, logm=logm)
    b, nb = tr_scaled.shape
    feats = torch.empty((b, nb * PAIRS), dtype=torch.float32, device=grams.device)
    flags = torch.empty((b, nb), dtype=torch.bool, device=grams.device)
    if b == 0:
        return feats, flags
    lib = _library()
    if logm == "chebyshev":
        return _launch_chebyshev(lib, grams, tr_scaled, wwt_pairs, coeffs, feats, flags, **kw)
    if terms > lib.nsd_logcov_feats_max_terms():
        raise ValueError(f"{terms} poles exceed the kernel's limit of {lib.nsd_logcov_feats_max_terms()}")
    with torch.cuda.device(grams.device):
        stream = torch.cuda.current_stream(grams.device).cuda_stream
        err = lib.nsd_logcov_feats(
            grams.data_ptr(), tr_scaled.data_ptr(), wwt_pairs.data_ptr(),
            feats.data_ptr(), flags.data_ptr(), b, nb, cbuf, terms,
            scale, alpha, lo, hi, guard_g, stream,
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(NAME)
    return feats, flags


def _launch_chebyshev(lib, grams, tr_scaled, wwt_pairs, coeffs, feats, flags, *, scale, alpha, lo, hi, guard_g):
    degree = len(coeffs) - 1
    if degree > lib.nsd_logcov_feats_max_degree():
        raise ValueError(f"degree {degree} exceeds the kernel's limit of {lib.nsd_logcov_feats_max_degree()}")
    cbuf = device_coeffs(tuple(float(c) for c in coeffs), grams.device)
    b, nb = tr_scaled.shape
    with torch.cuda.device(grams.device):
        stream = torch.cuda.current_stream(grams.device).cuda_stream
        err = lib.nsd_logcov_feats_chebyshev(
            grams.data_ptr(), tr_scaled.data_ptr(), wwt_pairs.data_ptr(),
            feats.data_ptr(), flags.data_ptr(), b, nb, cbuf.data_ptr(), degree,
            scale, alpha, lo, hi, guard_g, stream,
        )
    if err != 0:
        msg = lib.nsd_cuda_error_string(err).decode()
        raise RuntimeError(f"{CHEB_NAME} kernel launch failed: CUDA error {err} ({msg})")
    kernels.count_launch(CHEB_NAME)
    return feats, flags
