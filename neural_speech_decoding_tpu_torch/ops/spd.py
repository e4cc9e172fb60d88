"""Batched 8x8 SPD algebra of the log-covariance features, as plain PyTorch.

The stages of JAX models/logcov.py:250-427 and :686-690 (Chebyshev-Clenshaw
matrix log, unrolled pivot-free Gauss-Jordan inverse, rational matrix log,
eigendecomposition log, unrolled Cholesky PD test, spectrum guard), written on [..., C, C] tensors with
explicit scalars so that models/logcov.py (the stages path) and the
kernels' plain twins (ops/kernels/logmfeats.py, ops/kernels/logm.py) run
the same arithmetic. Every elementwise step
is one IEEE-rounded PyTorch op. The shrinkage, trace and Cholesky test are
in the order the feature kernel (csrc/logcov_feats.cu) does them, without
FMAs, so the guard decides bit for bit as the kernel does; the kernel's
matrix log takes another route to the same resolvent sum (a tridiagonal
form, with FMAs), so there the two differ by rounding.
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


def chebyshev_domain_map(s: torch.Tensor, lo: float, hi: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, tr / C) for [..., C, C] SPD matrices: A = S / (tr S / C) mapped
    onto the Chebyshev domain, t = (2 A - (hi + lo) I) / (hi - lo), whose
    eigenvalues lie in [-1, 1] when those of A lie in [lo, hi]."""
    c = s.shape[-1]
    eye = eye_like(s)
    tr = trace(s)[..., None, None] / c
    a = s / tr
    return (2.0 * a - (hi + lo) * eye) / (hi - lo), tr


def clenshaw(t: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """sum_k c_k T_k(t) of [..., C, C] matrices t by the matrix Clenshaw
    recurrence b0 = c_k I + 2 t b1 - b2 for k = degree..1, then
    c_0 I + t b1 - b2. Coefficients are rounded to t's dtype; the products
    are full precision (the callers keep TF32 off)."""
    cs = torch.tensor(coeffs, dtype=torch.float64).to(t.dtype).tolist()
    eye = eye_like(t)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for ck in cs[:0:-1]:
        b1, b2 = ck * eye + 2.0 * torch.matmul(t, b1) - b2, b1
    return cs[0] * eye + torch.matmul(t, b1) - b2


def logm_chebyshev(s: torch.Tensor, coeffs: Sequence[float], lo: float, hi: float) -> torch.Tensor:
    """logm of [..., C, C] SPD matrices as the Chebyshev series of log on
    [lo, hi] of the trace-normalised matrix, plus log(tr S / C) I (JAX
    models/logcov.py:250-284, _logm_spd_chebyshev)."""
    t, tr = chebyshev_domain_map(s, lo, hi)
    return clenshaw(t, coeffs) + torch.log(tr) * eye_like(s)


# torch.linalg.eigh on CUDA (cuSOLVER's batched solver) refuses a batch of
# 32768 8x8 matrices or more with CUSOLVER_STATUS_INVALID_VALUE (H100,
# torch 2.11, CUDA 12.8) and takes 16384; larger batches go in chunks.
EIGH_BATCH = 16384


def logm_eigh(s: torch.Tensor) -> torch.Tensor:
    """logm of [..., C, C] symmetric matrices by eigendecomposition,
    eigenvalues clamped at 1e-12 (JAX models/logcov.py:686-690)."""
    c = s.shape[-1]
    flat = s.reshape(-1, c, c)
    if flat.shape[0] == 0:
        return torch.empty_like(s)
    outs = []
    for part in flat.split(EIGH_BATCH):
        w, v = torch.linalg.eigh(part)
        outs.append(torch.matmul(v * torch.log(torch.clamp(w, min=1e-12))[..., None, :], v.transpose(-1, -2)))
    return torch.cat(outs).reshape(s.shape)


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
