"""Batched 8x8 SPD algebra of the log-covariance features, as plain PyTorch.

The stages of JAX models/logcov.py:310-427 (unrolled pivot-free
Gauss-Jordan inverse, rational matrix log, unrolled Cholesky PD test,
spectrum guard), written on [..., C, C] tensors with explicit scalars so
that models/logcov.py (the stages path) and the feature kernel's plain twin
(ops/kernels/logmfeats.py) run the same arithmetic. Every elementwise step
is one IEEE-rounded PyTorch op. The shrinkage, trace and Cholesky test are
in the order the feature kernel (csrc/logcov_feats.cu) does them, without
FMAs, so the guard decides bit for bit as the kernel does; in the
Gauss-Jordan steps the kernel forms FMAs, so there the two differ by
rounding.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

SQRT2 = math.sqrt(2.0)


def trace(s: torch.Tensor) -> torch.Tensor:
    """[..., C, C] -> [...]: the diagonal summed in index order."""
    tr = s[..., 0, 0]
    for i in range(1, s.shape[-1]):
        tr = tr + s[..., i, i]
    return tr


def eye_like(s: torch.Tensor) -> torch.Tensor:
    return torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)


def inv_tiny_spd(m: torch.Tensor) -> torch.Tensor:
    """[..., C, C] SPD inverse by unrolled pivot-free Gauss-Jordan in the
    uniform rank-1 form: g = m[:, i] - e_i lands the pivot row exactly on
    its scaled value, so no row is replaced."""
    c = m.shape[-1]
    eye = eye_like(m).expand(m.shape)
    inv = eye
    for i in range(c):
        r = 1.0 / m[..., i : i + 1, i : i + 1]
        mrow = m[..., i : i + 1, :] * r
        vrow = inv[..., i : i + 1, :] * r
        g = m[..., :, i : i + 1] - eye[..., :, i : i + 1]
        m = m - g * mrow
        inv = inv - g * vrow
    return inv


def logm_rational(
    s: torch.Tensor, c0: float, poles: Sequence[float], weights: Sequence[float]
) -> torch.Tensor:
    """logm of [..., C, C] SPD matrices: A = S / (tr S / C), then
    c0 I + sum_j v_j (A - p_j I)^{-1} + log(tr S / C) I. Every shift is
    SPD (p_j < 0), so the pivot-free elimination is stable."""
    c = s.shape[-1]
    eye = eye_like(s)
    tr = trace(s)[..., None, None] / c
    a = s / tr
    out = c0 * eye.expand(a.shape)
    for p, v in zip(poles, weights):
        out = out + v * inv_tiny_spd(a - p * eye)
    return out + torch.log(tr) * eye


def pd_mask(m: torch.Tensor) -> torch.Tensor:
    """[..., C, C] -> [...] bool: positive definite by Sylvester's
    criterion, through an unrolled Cholesky whose every pivot must be
    positive. Clamped pivots keep the discarded factor finite."""
    c = m.shape[-1]
    low = {}
    ok = None
    for j in range(c):
        d = m[..., j, j]
        for k in range(j):
            d = d - low[(j, k)] * low[(j, k)]
        ok = (d > 0) if ok is None else ok & (d > 0)
        ljj = torch.sqrt(torch.clamp(d, min=1e-30))
        for i in range(j + 1, c):
            t = m[..., i, j]
            for k in range(j):
                t = t - low[(i, k)] * low[(j, k)]
            low[(i, j)] = t / ljj
    return ok


def domain_flags(s: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """[..., C, C] -> [...] bool: the trace-normalised spectrum leaves
    [lo, hi]. lambda_min(A) >= lo iff A - lo I is PD; the upper edge needs
    its own test only when hi < C (the eigenvalues sum to C)."""
    c = s.shape[-1]
    eye = eye_like(s)
    tr = torch.clamp(trace(s), min=1e-30)[..., None, None] / c
    a = s / tr
    bad = ~pd_mask(a - lo * eye)
    if hi < c:
        bad = bad | ~pd_mask(hi * eye - a)
    return bad


def guard_spectrum(
    s: torch.Tensor, lo: float, hi: float, g: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(guarded [..., C, C], flags [...]): flagged matrices are shrunk
    toward (tr/C) I with strength g, hard enough to land in the domain;
    the others pass through bit-identical."""
    bad = domain_flags(s, lo, hi)
    c = s.shape[-1]
    tr = trace(s)[..., None, None] / c
    shrunk = (1.0 - g) * s + g * (tr + 1e-12) * eye_like(s)
    return torch.where(bad[..., None, None], shrunk, s), bad


def triu_features(logm: torch.Tensor) -> torch.Tensor:
    """[B, nb, C, C] -> [B, nb * C(C+1)/2]: the upper triangle row-major,
    off-diagonals weighted by sqrt(2) (the tangent-space isometry)."""
    c = logm.shape[-1]
    iu, ju = torch.triu_indices(c, c, device=logm.device)
    weights = torch.where(iu == ju, 1.0, SQRT2).to(logm.dtype)
    feats = logm[..., iu, ju] * weights
    return feats.reshape(feats.shape[0], -1)


def pairs_to_matrix(pairs: torch.Tensor, c: int) -> torch.Tensor:
    """[..., C(C+1)/2] upper-triangle pairs, row-major (the pair order
    p of the kernels) -> symmetric [..., C, C]."""
    iu, ju = torch.triu_indices(c, c, device=pairs.device)
    out = pairs.new_zeros(pairs.shape[:-1] + (c, c))
    out[..., iu, ju] = pairs
    out[..., ju, iu] = pairs
    return out
