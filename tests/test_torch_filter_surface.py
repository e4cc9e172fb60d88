"""The filter's public surface in the port, held against the JAX package
with x64 on: `kuramoto_operator`, `kuramoto_operator_from_analytic`,
`KuramotoSpatialFilter`, `kuramoto_spatial_filter` (float64, within 1e-9
of the largest |value|) and `instantaneous_phase` (within 1e-12 after
wrapping the difference to (-pi, pi]). Inputs are made with numpy from a
seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.ops import hilbert as jax_hilbert
from neural_speech_decoding_tpu.ops import kuramoto as jax_kuramoto
from neural_speech_decoding_tpu_torch.ops import hilbert, kuramoto

REL_TOL = 1e-9
PHASE_TOL = 1e-12
C = 8


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def eeg_ct(t: int, seed: int, scale: float = 20.0) -> np.ndarray:
    """A board-like recording [C, t]: sinusoids, slow modulation, noise."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t) / 125.0
    x = np.sin(2 * np.pi * (8 + np.arange(C))[:, None] * ts + rng.uniform(0, 2 * np.pi, (C, 1)))
    x = x + 0.4 * np.sin(2 * np.pi * 2.0 * ts + np.arange(C)[:, None])
    return scale * (x + 0.35 * rng.standard_normal((C, t)))


def test_jax_runs_in_float64():
    assert jax.config.read("jax_enable_x64")


@pytest.mark.parametrize("t", [625, 97, 1250])
def test_kuramoto_operator_matches_jax(t):
    phases = np.random.default_rng(t).uniform(-np.pi, np.pi, (t, C))
    want = np.asarray(jax_kuramoto.kuramoto_operator(jnp.asarray(phases)))
    got = kuramoto.kuramoto_operator(torch.from_numpy(phases))
    assert got.dtype == torch.float64
    assert rel_err(got, want) <= REL_TOL
    assert np.all(np.diag(got.numpy()) == 0.0)


def test_kuramoto_operator_batched():
    """Leading batch dimensions: each window's operator equals the single
    window's."""
    phases = np.random.default_rng(1).uniform(-np.pi, np.pi, (3, 625, C))
    got = kuramoto.kuramoto_operator(torch.from_numpy(phases)).numpy()
    for b in range(3):
        want = np.asarray(jax_kuramoto.kuramoto_operator(jnp.asarray(phases[b])))
        assert rel_err(got[b], want) <= REL_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_kuramoto_operator_from_analytic_matches_jax(seed):
    x = eeg_ct(625, seed).T
    x[:, 3] = 0.0  # a dead channel: z == 0, phase 0
    z = np.array(jax_hilbert.analytic_signal(jnp.asarray(x), axis=0))
    want = np.asarray(jax_kuramoto.kuramoto_operator_from_analytic(jnp.asarray(z)))
    got = kuramoto.kuramoto_operator_from_analytic(torch.from_numpy(z))
    assert got.dtype == torch.float64
    assert rel_err(got, want) <= REL_TOL
    # the phases' form of the same operator
    phases = np.asarray(jax_hilbert.instantaneous_phase(jnp.asarray(x), axis=0))
    assert rel_err(kuramoto.kuramoto_operator(torch.from_numpy(phases)), want) <= 1e-6


@pytest.mark.parametrize("lambd, renorm", [(1e-25, "diag"), (1e-34, "diag"), (1e-20, "diag"), (1e-3, "none")])
@pytest.mark.parametrize("t", [625, 7500])
def test_spatial_filter_matches_jax(lambd, renorm, t):
    x = eeg_ct(t, seed=t + 3)
    want = jax_kuramoto.KuramotoSpatialFilter(lambd=lambd, renorm=renorm).fit_transform(x)
    est = kuramoto.KuramotoSpatialFilter(lambd=lambd, renorm=renorm, device="cpu")
    got = est.fit_transform(x)
    assert got.dtype == np.float64 and got.shape == x.shape
    assert rel_err(got, want) <= REL_TOL
    assert est.fit(x) is est
    assert rel_err(est.transform(x), want) <= REL_TOL


def test_spatial_filter_function_form_matches_jax():
    x = eeg_ct(625, seed=9)
    want = jax_kuramoto.kuramoto_spatial_filter(x, 1e-30)
    got = kuramoto.kuramoto_spatial_filter(x, 1e-30, device="cpu")
    assert rel_err(got, want) <= REL_TOL
    assert rel_err(kuramoto.kuramoto_spatial_filter(x.tolist(), 1e-30, device="cpu"), want) <= REL_TOL


@pytest.mark.parametrize("shape, axis", [((625,), -1), ((C, 625), -1), ((625, C), 0), ((2, 97, C), 1)])
def test_instantaneous_phase_matches_jax(shape, axis):
    x = np.random.default_rng(len(shape)).standard_normal(shape) * 30.0
    want = np.asarray(jax_hilbert.instantaneous_phase(jnp.asarray(x), axis=axis))
    got = hilbert.instantaneous_phase(torch.from_numpy(x), dim=axis).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    wrapped = np.angle(np.exp(1j * (got - want)))
    assert np.abs(wrapped).max() <= PHASE_TOL


def test_instantaneous_phase_float32_follows_dtype():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 625)).astype(np.float32))
    assert hilbert.instantaneous_phase(x).dtype == torch.float32


def test_surface_exported():
    from neural_speech_decoding_tpu_torch import ops

    for name in ("kuramoto_operator", "kuramoto_operator_from_analytic", "KuramotoSpatialFilter",
                 "kuramoto_spatial_filter", "instantaneous_phase"):
        assert hasattr(ops, name)


def test_spatial_filter_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kuramoto.KuramotoSpatialFilter()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kuramoto.kuramoto_spatial_filter(eeg_ct(625, 0))
    with pytest.raises(RuntimeError, match="not available"):
        kuramoto.KuramotoSpatialFilter(device="cuda")
