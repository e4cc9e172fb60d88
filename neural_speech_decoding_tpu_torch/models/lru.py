"""Linear Recurrent Unit (LRU) decoder, eval path.

Counterpart of neural_speech_decoding_tpu/models/lru.py:46-251. A diagonal
complex linear recurrence h_t = lam h_{t-1} + u_t, with
lam = exp(-exp(nu) + i exp(theta)) and u_t = gamma B x_t,
gamma = sqrt(1 - |lam|^2), all in complex64. Two engines
(LRUConfig.scan_impl), as in the JAX package:

  * "chunked" (default): within a chunk of L steps (the largest divisor of
    T up to 128: 125 at T = 625) the states are one causal matmul against
    the kernel lam^(i-j) (masked before exp, so exp only sees exponents
    >= 0), and the chunks couple through a serial carry over T / L steps,
    which emits the carry entering each chunk;
  * "associative": a log-depth doubling scan over time (the chunked
    engine's test oracle).

Readout: Re(h C) -> tanh-GELU -> attention pooling over time -> LayerNorm
(mean of squares) -> tanh-GELU MLP.

No LRU checkpoint is shipped; `random_lru_params` draws parameters of the
JAX init's shapes and distributions with numpy, from a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LRUConfig:
    num_channels: int = 8
    num_classes: int = 3
    hidden: int = 64  # complex state dimension
    readout: int = 48  # real features per step after the C-matrix readout
    mlp_hidden: int = 32
    r_min: float = 0.6  # eigenvalue ring at init
    r_max: float = 0.999
    max_phase: float = 6.28
    dropout: float = 0.2
    ln_eps: float = 1e-5
    scan_impl: str = "chunked"  # "chunked" | "associative"
    # chunk length of the chunked engine; None picks the largest divisor
    # of T that is <= 128
    chunk: Optional[int] = None


def random_lru_params(seed: int, cfg: LRUConfig = LRUConfig()) -> Params:
    """A float32 numpy parameter pytree of the shapes and distributions of
    the JAX package's init_lru_params (models/lru.py:90-133): eigenvalue
    moduli area-uniform on the ring [r_min, r_max], phases uniform in
    [0, max_phase), Gaussian B, C and head weights at the same scales."""
    rng = np.random.default_rng(seed)
    h, c, r = cfg.hidden, cfg.num_channels, cfg.readout
    mod = np.sqrt(rng.uniform(size=h) * (cfg.r_max**2 - cfg.r_min**2) + cfg.r_min**2)
    phase = rng.uniform(size=h) * cfg.max_phase

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "nu": np.log(-np.log(mod)).astype(np.float32),
        "theta": np.log(np.maximum(phase, 1e-4)).astype(np.float32),
        "b_re": normal((c, h), np.sqrt(1.0 / c)),
        "b_im": normal((c, h), np.sqrt(1.0 / c)),
        "c_re": normal((h, r), np.sqrt(1.0 / h)),
        "c_im": normal((h, r), np.sqrt(1.0 / h)),
        "ln": {"scale": np.ones(r, np.float32), "bias": np.zeros(r, np.float32)},
        "attn": {"w": normal((r, 1), np.sqrt(1.0 / r)), "b": np.zeros(1, np.float32)},
        "fc1": {"w": normal((r, cfg.mlp_hidden), np.sqrt(2.0 / r)), "b": np.zeros(cfg.mlp_hidden, np.float32)},
        "fc2": {
            "w": normal((cfg.mlp_hidden, cfg.num_classes), np.sqrt(1.0 / cfg.mlp_hidden)),
            "b": np.zeros(cfg.num_classes, np.float32),
        },
    }


def _input_drive(params: Params, x_btc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_t = gamma B x_t ([B, T, H] complex64) and log(lambda) [H]."""
    log_lam = torch.complex(-torch.exp(params["nu"]), torch.exp(params["theta"]))
    lam = torch.exp(log_lam)
    gamma = torch.sqrt(torch.clamp(1.0 - torch.abs(lam) ** 2, min=1e-6)).to(torch.complex64)
    b = torch.complex(params["b_re"], params["b_im"])
    u = (x_btc.to(torch.complex64) @ b) * gamma
    return u, log_lam


def _chunk_len(t: int, requested: Optional[int]) -> int:
    if requested is not None:
        if t % requested:
            raise ValueError(f"chunk={requested} does not divide T={t}")
        return requested
    best = 1
    for cand in range(2, min(t, 128) + 1):
        if t % cand == 0:
            best = cand
    return best


def _lru_states_chunked(params: Params, x_btc: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """[B, T, C] -> complex states [B, T, H], chunked-kernel engine."""
    u, log_lam = _input_drive(params, x_btc)
    bsz, t, h = u.shape
    el = _chunk_len(t, chunk)
    nc = t // el

    k = torch.arange(el, device=u.device)
    diff = (k[:, None] - k[None, :]).to(torch.float32)  # [L, L]
    kern = torch.where(
        (diff >= 0)[..., None],
        torch.exp(torch.clamp(diff, min=0)[..., None] * log_lam),
        torch.zeros((), dtype=torch.complex64, device=u.device),
    )  # [L, L, H]
    # hloc[b, n, i, h] = sum_j kern[i, j, h] u[b, n, j, h]: one [L, L]
    # product per hidden state over the B * nc chunk columns
    cols = u.reshape(bsz * nc, el, h).permute(2, 1, 0)  # [H, L, B*nc]
    hloc = (kern.permute(2, 0, 1) @ cols).permute(2, 1, 0).reshape(bsz, nc, el, h)

    # serial carry across chunks: c_n = lam^L c_{n-1} + hloc[n, L-1]
    lam_l = torch.exp(float(el) * log_lam)  # [H]
    carry = torch.zeros((bsz, h), dtype=torch.complex64, device=u.device) + u[:, :1, 0] * 0.0
    prevs = []
    for n in range(nc):
        prevs.append(carry)  # the carry ENTERING chunk n
        carry = lam_l * carry + hloc[:, n, -1]
    prevs = torch.stack(prevs, dim=1)  # [B, nc, H]

    lam_ip1 = torch.exp((k + 1.0)[:, None] * log_lam[None, :])  # [L, H]
    full = hloc + prevs[:, :, None, :] * lam_ip1
    return full.reshape(bsz, t, h)


def _lru_states_associative(params: Params, x_btc: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> complex states [B, T, H] by a log-depth doubling scan of
    the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2). The
    transition is the same for every window, so a is kept once, [T, H]."""
    u, log_lam = _input_drive(params, x_btc)
    t = u.shape[1]
    a = torch.exp(log_lam).expand(t, -1)
    b = u
    d = 1
    while d < t:
        b = torch.cat([b[:, :d], a[d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:d], a[:-d] * a[d:]], dim=0)
        d *= 2
    return b


def _lru_states(params: Params, x_btc: torch.Tensor, cfg: LRUConfig) -> torch.Tensor:
    if cfg.scan_impl == "chunked":
        return _lru_states_chunked(params, x_btc, cfg.chunk)
    if cfg.scan_impl == "associative":
        return _lru_states_associative(params, x_btc)
    raise ValueError(f"unknown scan_impl {cfg.scan_impl!r}")


def lru_apply(params: Params, x_btc: torch.Tensor, cfg: LRUConfig = LRUConfig()) -> torch.Tensor:
    """[B, T, C] -> logits [B, num_classes], eval mode (no dropout)."""
    h = _lru_states(params, x_btc.to(torch.float32), cfg)
    cc = torch.complex(params["c_re"], params["c_im"])
    y = F.gelu((h @ cc).real, approximate="tanh")  # [B, T, readout]
    scores = y @ params["attn"]["w"] + params["attn"]["b"]  # [B, T, 1]
    pooled = (y * torch.softmax(scores, dim=1)).sum(dim=1)  # [B, readout]
    mean = pooled.mean(dim=-1, keepdim=True)
    var = torch.square(pooled - mean).mean(dim=-1, keepdim=True)
    f = (pooled - mean) / torch.sqrt(var + cfg.ln_eps)
    f = f * params["ln"]["scale"] + params["ln"]["bias"]
    f = F.gelu(f @ params["fc1"]["w"] + params["fc1"]["b"], approximate="tanh")
    return f @ params["fc2"]["w"] + params["fc2"]["b"]
