"""Kuramoto-phase spatial filter ("MAI filter").

Counterpart of neural_speech_decoding_tpu/ops/kuramoto.py. Per window
x [T, C]:

  1. analytic signal z = x + i H x (dense Hilbert operator, or the FFT in
     float64 mode)
  2. cos 2phi = (re^2 - im^2) / |z|^2, sin 2phi = 2 re im / |z|^2, with
     cos 2phi = 1, sin 2phi = 0 where |z|^2 < f32 tiny (np.angle(0) == 0)
  3. pair desynchrony P = (T - G) / 2 with the gram
     G[i, j] = sum_t (c2_i c2_j + s2_i s2_j) and the diagonal forced to 0
  4. ridge: out = x (I + lambda_eff P^T P)^-T

The public surface beside the filter: `kuramoto_operator` (from phases),
`kuramoto_operator_from_analytic`, and the sklearn-style
`KuramotoSpatialFilter` / `kuramoto_spatial_filter` on [C, T] numpy data,
and `mai_filter_batch_sharded`, the batched filter over a device mesh.

Every function takes leading batch dimensions: [..., T, C]. The batched
fast path gets G from ops/kernels/kuramoto.kuramoto_pair_sums, which is
the hand-written CUDA kernel for a CUDA tensor and its plain twin for a
CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.ops.hilbert import (
    analytic_signal,
    analytic_signal_matmul,
)
from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
    cos_sin_2phi,
    kuramoto_pair_sums,
)
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device


def _wide_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "highest" else torch.float32


def _effective_lambda(config: FilterConfig, lambd: Optional[float] = None) -> float:
    """Tailoring lambda with the reference's diag-renorm quirk folded in.

    The operator's diagonal is identically zero, so the renorm's
    d = sqrt(clip(diag(P), eps)) always lands on eps and the renorm is a
    global multiply by 1/eps. Folding it into lambda (lambda / eps^2) keeps
    P^T P at O(T^2) magnitudes that float32 holds.
    """
    if lambd is None:
        lambd = config.lambd
    if config.renorm == "diag":
        lambd = lambd / (config.eps * config.eps)
    return lambd


def _operator_from_gram(gram: torch.Tensor, t: int) -> torch.Tensor:
    """P = (T - G) / 2 with the diagonal forced to exactly 0 (the
    reference's pair loop never writes it). gram [..., C, C]."""
    c = gram.shape[-1]
    p = 0.5 * (torch.tensor(t, dtype=gram.dtype, device=gram.device) - gram)
    return p * (1.0 - torch.eye(c, dtype=p.dtype, device=p.device))


def _operator_from_cs(c2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """P [..., C, C] from cos 2phi and sin 2phi [..., T, C]: one
    [C, 2T] x [2T, C] gram per window, as the JAX stages path forms it."""
    m = torch.cat([c2, s2], dim=-2)
    return _operator_from_gram(torch.matmul(m.transpose(-1, -2), m), c2.shape[-2])


def kuramoto_operator(phases_tc: torch.Tensor) -> torch.Tensor:
    """Pair-desynchrony operator from phases [..., T, C] -> P [..., C, C],
    in the phases' dtype on their device (JAX ops/kuramoto.py:85-103)."""
    return _operator_from_cs(torch.cos(2.0 * phases_tc), torch.sin(2.0 * phases_tc))


def kuramoto_operator_from_parts(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Pair-desynchrony operator from (real, imag) of the analytic signal
    [..., T, C] -> P [..., C, C], with no angle, cos or sin: cos 2phi =
    (re^2 - im^2) / |z|^2, sin 2phi = 2 re im / |z|^2."""
    return _operator_from_cs(*cos_sin_2phi(re, im))


def kuramoto_operator_from_analytic(z: torch.Tensor) -> torch.Tensor:
    """The operator from the complex analytic signal z [..., T, C] (JAX
    ops/kuramoto.py:135-140)."""
    return kuramoto_operator_from_parts(z.real, z.imag)


def _mm_tiny(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., C, C] @ [..., C, C] as a compensated broadcast multiply-sum.

    Dekker TwoProduct for each a[i,k] * b[k,j] and a branch-free Knuth
    TwoSum over k, with the errors carried in a parallel term. A plain f32
    sum of the products missed the 1e-4 logit budget in the JAX package
    (3.1e-4); the compensated form is about f64 quality. Each torch op
    rounds on its own in eager mode, which the error-free transforms need.
    """
    split = torch.tensor(4097.0, dtype=a.dtype, device=a.device)  # 2^12 + 1
    x = a[..., :, :, None]  # [..., i, k, 1]
    y = b[..., None, :, :]  # [..., 1, k, j]
    p = x * y
    xh = x * split - (x * split - x)
    xl = x - xh
    yh = y * split - (y * split - y)
    yl = y - yh
    perr = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    s = p[..., 0, :]
    c = perr[..., 0, :]
    for k in range(1, p.shape[-2]):
        t = p[..., k, :]
        new = s + t
        bv = new - s
        c = c + ((s - (new - bv)) + (t - bv)) + perr[..., k, :]
        s = new
    return s + c


def _solve_gauss_jordan(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve A X = Y for tiny SPD systems with unrolled pivot-free
    Gauss-Jordan elimination. A = I + lambda P^T P has a unit-plus
    diagonal, so the pivots stay >= 1. a [..., C, C], y [..., C, N]."""
    c = a.shape[-1]
    m = torch.cat([a, y], dim=-1)  # [..., C, C+N]
    for i in range(c):
        row = m[..., i, :] / m[..., i, i : i + 1]
        m = m - m[..., :, i : i + 1] * row[..., None, :]
        m[..., i, :] = row
    return m[..., :, c:]


def _ridge_apply_fast(x_tc: torch.Tensor, p: torch.Tensor, lambd_eff: float) -> torch.Tensor:
    """Fast-mode ridge: invert A = I + lambda_eff P^T P (unrolled GJ plus
    one Newton-Schulz step X <- X (2I - A X)) and apply it to the window."""
    c = x_tc.shape[-1]
    eye = torch.eye(c, dtype=x_tc.dtype, device=x_tc.device)
    lam = torch.tensor(lambd_eff, dtype=x_tc.dtype, device=x_tc.device)
    a = eye + lam * _mm_tiny(p.transpose(-1, -2), p)
    inv = _solve_gauss_jordan(a, eye.expand_as(a))
    inv = _mm_tiny(inv, 2.0 * eye - _mm_tiny(a, inv))
    return torch.matmul(x_tc, inv.transpose(-1, -2))


def mai_filter(
    x_tc: torch.Tensor,
    config: Optional[FilterConfig] = None,
    *,
    lambd: Optional[float] = None,
) -> torch.Tensor:
    """Stages form of the filter on [..., T, C] -> float32 [..., T, C], on
    the tensor's own device. "highest" runs in float64 with the FFT analytic
    signal and an LU solve; "fast" in float32 with the dense Hilbert
    operator and the Gauss-Jordan ridge."""
    config = config or FilterConfig()
    dtype = _wide_dtype(config.precision)
    x = x_tc.to(dtype)
    if dtype == torch.float64:
        z = analytic_signal(x, dim=-2)
        re, im = z.real, z.imag
    else:
        re, im = analytic_signal_matmul(x)
    p = kuramoto_operator_from_parts(re, im)
    lam = _effective_lambda(config, lambd)
    if config.precision == "fast":
        out = _ridge_apply_fast(x, p, lam)
    else:
        c = x.shape[-1]
        eye = torch.eye(c, dtype=dtype, device=x.device)
        a = eye + torch.tensor(lam, dtype=dtype, device=x.device) * _mm_tiny(
            p.transpose(-1, -2), p
        )
        out = torch.linalg.solve(a, x.transpose(-1, -2)).transpose(-1, -2)
    return out.to(torch.float32)


class KuramotoSpatialFilter:
    """sklearn-style estimator over the filter on [C, T] numpy data, the
    vendored package's API surface (JAX ops/kuramoto.py:285-307). It runs
    `mai_filter` in "highest" mode (float64, FFT analytic signal, LU solve)
    on `device`, CUDA unless the caller names another, and returns float64
    numpy [C, T] (the filter's float32 output, widened, as in JAX)."""

    def __init__(self, lambd: float = 1e-25, renorm: str = "diag", device: DeviceLike = None):
        self.lambd = float(lambd)
        self.renorm = renorm
        self.device = resolve_device(device)
        self._config = FilterConfig(lambd=self.lambd, renorm=renorm)

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        x_tc = torch.from_numpy(np.ascontiguousarray(np.asarray(X, dtype=np.float64).T))
        out = mai_filter(x_tc.to(self.device), self._config)
        return out.cpu().numpy().T.astype(np.float64)

    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X, y)


def kuramoto_spatial_filter(data_ct, lambda_val: float = 1e-25, device: DeviceLike = None):
    """Function form of the filter on [C, T] data (the vendored package's
    `mindsai_python_filter` signature; JAX ops/kuramoto.py:310-313)."""
    return KuramotoSpatialFilter(lambd=lambda_val, device=device).fit_transform(data_ct)


def _mai_filter_batch_fused(x_btc: torch.Tensor, config: FilterConfig) -> torch.Tensor:
    """Fused route: Hilbert + c2/s2 + pair sums in one kernel (plain twin
    on the CPU), then the fast ridge. Same math as mai_filter in fast mode
    (neural_speech_decoding_tpu/ops/kuramoto.py:316-334)."""
    x = x_btc.to(torch.float32).contiguous()
    gram = kuramoto_pair_sums(x)  # [B, C, C]
    p = _operator_from_gram(gram, x.shape[1])
    return _ridge_apply_fast(x, p, _effective_lambda(config))


def mai_filter_batch(
    windows_btc,
    config: Optional[FilterConfig] = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Batched filter [B, T, C] -> float32 [B, T, C] on `device` (CUDA unless
    the caller names another device). Fast mode takes the pair-sums kernel;
    highest mode takes the stages path."""
    config = config or FilterConfig()
    dev = resolve_device(device)
    x = torch.as_tensor(windows_btc, device=dev)
    if x.dim() != 3:
        raise ValueError(f"expected windows [B, T, C], got shape {tuple(x.shape)}")
    if config.precision == "fast":
        return _mai_filter_batch_fused(x, config)
    return mai_filter(x, config)


def mai_filter_batch_sharded(
    windows_btc,
    config: Optional[FilterConfig] = None,
    *,
    mesh,
    axis: str = "dp",
) -> torch.Tensor:
    """Batched filter over a device mesh (JAX ops/kuramoto.py:369-396): the
    batch splits over `axis`, each shard is filtered on its own device (the
    pair-sums kernel once a shard on the card), and the shards are
    concatenated on the mesh's primary device. The batch must divide by
    the axis' size."""
    from neural_speech_decoding_tpu_torch.parallel.sharding import batch_sharding, gather

    config = config or FilterConfig()
    shards = batch_sharding(mesh, windows_btc, axis)
    tasks = [(w.device, lambda w: mai_filter_batch(w, config, device=w.device), (w,)) for w in shards]
    return gather(mesh, mesh.run(tasks))
