"""Accurate float32 gate activations for the LSTM recurrence.

Counterpart of neural_speech_decoding_tpu/ops/gates.py:29-113, in both
gate_math modes. The JAX package evaluates tanh and sigmoid as a
13/6-degree odd minimax rational (tanh(x) = x P(x^2) / Q(x^2), clamped
where f32 tanh has saturated), built from multiplies, adds and one divide;
max abs error ~4e-7. The port evaluates the same rational with the same
operation order, so the two packages agree to the last few ulps instead of
to the distance between two tanh implementations compounded over 625
recurrent steps.

Only float32 takes the rational; other dtypes use torch's builtins.
"""

from __future__ import annotations

import torch

# Numerator (odd powers of x: coefficient of x^13 first) and denominator
# (even powers: x^6 first) of the minimax rational approximation.
_TANH_P = (
    -2.76076847742355e-16,
    2.00018790482477e-13,
    -8.60467152213735e-11,
    5.12229709037114e-08,
    1.48572235717979e-05,
    6.37261928875436e-04,
    4.89352455891786e-03,
)
_TANH_Q = (
    1.19825839466702e-06,
    1.18534705686654e-04,
    2.26843463243900e-03,
    4.89352518554385e-03,
)
# |x| beyond which f32 tanh(x) rounds to +/-1 exactly.
_TANH_SATURATION = 7.99


def tanh(x: torch.Tensor) -> torch.Tensor:
    """~1-ulp f32 tanh from correctly rounded mul/add/div."""
    if x.dtype != torch.float32:
        return torch.tanh(x)
    x = torch.clamp(x, -_TANH_SATURATION, _TANH_SATURATION)
    x2 = x * x
    p = torch.full_like(x2, _TANH_P[0])
    for coef in _TANH_P[1:]:
        p = x2 * p + coef
    q = torch.full_like(x2, _TANH_Q[0])
    for coef in _TANH_Q[1:]:
        q = x2 * q + coef
    return (x * p) / q


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) = 0.5 * (1 + tanh(x/2)) on the accurate tanh."""
    if x.dtype != torch.float32:
        return torch.sigmoid(x)
    return 0.5 + 0.5 * tanh(0.5 * x)


def sigmoid_fold_mask(h_dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[4H] mask that pre-halves the sigmoid gates' columns (i, f, o in torch
    order; g stays x1). With sigmoid(x) = 0.5 + 0.5 tanh(x/2), pre-halved
    inputs let ONE whole-block tanh cover all four gates; x0.5 is exact."""
    m = torch.ones(4 * h_dim, dtype=dtype, device=device)
    m[: 2 * h_dim] = 0.5
    m[3 * h_dim :] = 0.5
    return m


def lstm_gate_block(gates: torch.Tensor, h_dim: int, gate_math: str = "rational"):
    """(i, f, g, o) activations from one pre-activation block [..., 4H]
    (torch gate order). gate_math="rational" expects the i/f/o columns to
    have been pre-scaled with sigmoid_fold_mask: one whole-block tanh covers
    all four gates. "builtin" takes torch.sigmoid / torch.tanh on unscaled
    gates."""
    if gate_math == "rational":
        y = tanh(gates)
        sig = 0.5 + 0.5 * y
        tg = y
    elif gate_math == "builtin":
        sig = torch.sigmoid(gates)
        tg = torch.tanh(gates)
    else:
        raise ValueError(f"unknown gate_math {gate_math!r}")
    return (
        sig[..., 0 * h_dim : 1 * h_dim],
        sig[..., 1 * h_dim : 2 * h_dim],
        tg[..., 2 * h_dim : 3 * h_dim],
        sig[..., 3 * h_dim : 4 * h_dim],
    )


def cell_tanh(x: torch.Tensor, gate_math: str = "rational") -> torch.Tensor:
    """tanh of the cell state under the chosen gate_math."""
    return tanh(x) if gate_math == "rational" else torch.tanh(x)
