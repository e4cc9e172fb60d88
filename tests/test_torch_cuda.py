"""Tests of the port that need the card: each CUDA kernel (pair sums, band
grams, log-covariance features in both modes, the Clenshaw matrix log, the
zero-phase IIR cascade) against its plain twin, and the engines on CUDA
against the same engines on the CPU.

No JAX here (the machine with the card has none); run there with
  python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider
Elsewhere every test skips.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
    kuramoto_pair_sums,
    kuramoto_pair_sums_plain,
)
from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models import logcov
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kernels import iir as iir_kernels
from neural_speech_decoding_tpu_torch.ops.kernels import logm as logm_kernels
from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams, band_grams_plain
from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import logcov_feats, logcov_feats_plain
from neural_speech_decoding_tpu_torch.ops import spd
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "checkpoints" / "logcov8wd_ens_manifest.json"
CHEB_KW = {"whiten": True, "dropout": 0.0, "logm": "chebyshev"}
T, C = 625, 8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _windows(n: int, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((n, T, C)) * 40.0).astype(np.float32)
    x[0, :, 3] = 0.0  # dead channel: c2 = 1, s2 = 0
    return x


@pytest.mark.parametrize("batch", [1, 2, 3, 37])
def test_kernel_matches_plain(cuda, batch):
    """f32 tree sums of 625 O(1) terms in different orders: abs 2e-4 on
    values up to 625 (a running f32 sum over T reads about 1.7e-3)."""
    x = torch.from_numpy(_windows(batch, batch)).to(cuda)
    before = kernels.launches()["kuramoto_pair_sums"]
    got = kuramoto_pair_sums(x)
    torch.cuda.synchronize()
    assert kernels.launches()["kuramoto_pair_sums"] == before + 1
    want = kuramoto_pair_sums_plain(x)
    assert got.shape == (batch, C, C)
    assert (got - want).abs().max().item() <= 2e-4
    assert torch.equal(got, got.transpose(1, 2))
    assert got[0, 3, 3].item() == float(T)


@pytest.mark.parametrize("t_len", [97, 256, 1250])
@pytest.mark.parametrize("batch", [1, 37])
def test_kernel_other_window_lengths(cuda, t_len, batch):
    """The FFT plan of any T: 97 (prime: one direct-DFT stage), 256 (radix
    4), 1250 (10 s at 125 Hz: radices 2 and 5). Within 2e-4 of the twin,
    exactly symmetric, a dead channel's diagonal exactly T."""
    x = (np.random.default_rng(t_len + batch).standard_normal((batch, t_len, C)) * 40.0).astype(np.float32)
    x[0, :, 3] = 0.0
    x = torch.from_numpy(x).to(cuda)
    got = kuramoto_pair_sums(x)
    want = kuramoto_pair_sums_plain(x)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-4
    assert torch.equal(got, got.transpose(1, 2))
    assert got[0, 3, 3].item() == float(t_len)


def test_kernel_dead_channel_beside_railed_channel(cuda):
    """Each channel is its own transform: a dead channel next to one railed
    at 1e6 keeps im exactly 0, so its diagonal is exactly T and its row
    matches the twin's within the limit."""
    x = _windows(4, 13)
    x[:, :, 4] = 0.0
    x[:, :, 5] = 1e6 * np.sign(x[:, :, 5])
    x = torch.from_numpy(x).to(cuda)
    got = kuramoto_pair_sums(x)
    want = kuramoto_pair_sums_plain(x)
    torch.cuda.synchronize()
    assert torch.all(got[:, 4, 4] == float(T))
    assert (got[:, 4, :] - want[:, 4, :]).abs().max().item() <= 2e-4
    assert (got - want).abs().max().item() <= 2e-4


def _burst_windows(n: int, seed: int, channels=(2, 5)) -> np.ndarray:
    """`channels` mostly flat (noise of 1e-2) with three 20-sample bursts
    of amplitude 40: the bursts set the channels' mean x^2, so hundreds of
    flat samples a window fall under the near-zero threshold."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, T, C)) * 40.0).astype(np.float32)
    for w in range(n):
        for ch in channels:
            q = 0.01 * rng.standard_normal(T)
            for start in rng.integers(0, T - 20, 3):
                q[start : start + 20] += 40.0 * np.sin(0.9 * np.arange(20) + rng.uniform(0, 2 * np.pi))
            x[w, :, ch] = q
    return x


@pytest.mark.parametrize("channels", [(2, 5), tuple(range(C))])
@pytest.mark.parametrize("batch", [2, 37])
def test_kernel_burst_channels(cuda, batch, channels):
    """Hundreds of near-zero samples in every block (more than one round
    of its 256 threads), which take im as the twin's dense product; with
    every channel bursty, thousands (more than the block's queue, a
    quarter of its samples: the scan). Within 2e-4 of the twin, exactly
    symmetric, and against float64 at most twice the twin's error."""
    from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import refine_below
    from neural_speech_decoding_tpu_torch.ops.hilbert import hilbert_matrix

    x = torch.from_numpy(_burst_windows(batch, 40 + batch, channels)).to(cuda)
    got = kuramoto_pair_sums(x)
    want = kuramoto_pair_sums_plain(x)
    exact = kuramoto_pair_sums_plain(x.double())
    xd = x.double()
    im = torch.matmul(hilbert_matrix(T, cuda, torch.float64), xd)
    low = (xd * xd + im * im) < refine_below() * (xd * xd).mean(dim=1, keepdim=True)
    torch.cuda.synchronize()
    assert low[:2].sum().item() > (4 * T if len(channels) == C else 256)
    assert (got - want).abs().max().item() <= 2e-4
    assert torch.equal(got, got.transpose(1, 2))
    assert (got.double() - exact).abs().max().item() <= 2.0 * (want.double() - exact).abs().max().item()


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        kuramoto_pair_sums(torch.zeros(2, T, C, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        kuramoto_pair_sums(torch.zeros(2, T, 4, device=cuda))
    with pytest.raises(ValueError):
        kuramoto_pair_sums(torch.zeros(2, C, T, device=cuda).transpose(1, 2))
    assert kuramoto_pair_sums(torch.zeros(0, T, C, device=cuda)).shape == (0, C, C)


def test_engine_cuda_matches_cpu(cuda):
    """The whole pipeline on the card (kernel route) against the CPU (plain
    twin): <= 1e-4 max |delta logit|, the f32 fidelity budget."""
    path = str(REPO / "checkpoints" / "lstm3_retrained.npz")
    x = _windows(16, 7) / 40.0
    gpu = InferenceEngine(path).logits_batch(x)
    cpu = InferenceEngine(path, device="cpu").logits_batch(x)
    assert np.abs(gpu - cpu).max() <= 1e-4


def _logcov_kernel_inputs(batch: int, dev, cold: bool, logm: str = "rational"):
    """The flagship's kernel inputs for `batch` board-like windows through
    the card's filter: window 0 has channel 3 dead (from _windows) and
    channel 2 railed (x1e6), window 1 is
    all zero, window 2 has channel 5 at 0.002 sin. With `cold` the shipped
    whitener's gain on channel 5 is cut tenfold, so that the guard fires
    (under the shipped whitener it cannot: cond(W W^T) <= 21)."""
    x = _windows(batch, batch + 100) / 40.0
    if batch >= 3:
        x[0, :, 2] *= 1e6
        x[1] = 0.0
        x[2, :, 5] = 0.002 * np.sin(np.arange(T, dtype=np.float32) * 0.3)
    filtered = mai_filter_batch(x, FilterConfig(precision="fast"), device=dev)
    cfg = get_model("logcov8", whiten=True, dropout=0.0, logm=logm).config
    w = torch.from_numpy(load_params_npz(REPO / "checkpoints" / "logcov8wd_ens_s0.npz")["whitener"]).to(dev)
    if cold:
        w = w * torch.where(torch.arange(8, device=dev) == 5, 0.1, 1.0)[None, None, :]
    return logcov.kernel_inputs(filtered, w, cfg)


@pytest.mark.parametrize("batch", [1, 37, 1024])
def test_band_grams_kernel_matches_plain(cuda, batch):
    """Pair sums of at most 80 float32 products (logcov8), summed by the
    kernel in float64 and rounded once, and by the twin (cuBLAS) in
    float32: a running float32 sum of n terms errs by at most n * 2^-24 of
    the sum of |terms|, which is at most max|G| of the window; for the
    widest shipped band (180 rows) that is 1.1e-5. So the limit is 1e-5 of
    each window's max|G| (the railed window is 1e12 times larger than the
    others, so a limit on the whole batch would say nothing)."""
    k = _logcov_kernel_inputs(batch, cuda, cold=False)
    before = kernels.launches()["bandcov_grams"]
    got = band_grams(k.yw, k.offsets)
    torch.cuda.synchronize()
    assert kernels.launches()["bandcov_grams"] == before + 1
    want = band_grams_plain(k.yw, k.offsets)
    assert got.shape == (batch, 8 * 36) and torch.isfinite(got).all()
    per_window = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert ((got - want).abs() / per_window).max().item() <= 1e-5


@pytest.mark.parametrize("family", ["logcov", "logcov12"])
def test_band_grams_kernel_other_band_layouts(cuda, family):
    """The kernel is generic in R and nb: the broad 4-band layout (widest
    band 180 rows) and the 12-band one (R = 900), random rows, B = 37,
    against the twin with the same per-window limit."""
    _, slices = logcov._band_projector(T, get_model(family).config)
    offsets = (0,) + tuple(sl.stop for sl in slices)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal((37, offsets[-1], C)).astype(np.float32)).to(cuda)
    got = band_grams(y, offsets)
    want = band_grams_plain(y, offsets)
    torch.cuda.synchronize()
    assert got.shape == (37, (len(offsets) - 1) * 36)
    per_window = want.abs().amax(dim=1, keepdim=True)
    assert ((got - want).abs() / per_window).max().item() <= 1e-5


def _gram_layout(name: str):
    """Band offsets: a family's layout, or 16 bands of 1 to 61 rows."""
    if name == "16 bands":
        return (0,) + tuple(int(o) for o in np.cumsum(np.random.default_rng(16).integers(1, 62, 16)))
    _, slices = logcov._band_projector(T, get_model(name).config)
    return (0,) + tuple(sl.stop for sl in slices)


def _gram_errors(y: torch.Tensor, offsets):
    """The kernel's grams, and their largest error of each window's max|G|
    against the float32 twin and against the float64 twin."""
    got = band_grams(y, offsets)
    want = band_grams_plain(y, offsets)
    exact = band_grams_plain(y.double(), offsets)
    torch.cuda.synchronize()
    norm = exact.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    return got, ((got - want).abs() / norm).max().item(), ((got.double() - exact).abs() / norm).max().item()


@pytest.mark.parametrize("batch", [1, 37, 1024, 16384])
def test_band_grams_kernel_within_one_ulp_of_float64(cuda, batch):
    """The flagship's rows (a railed window and an all-zero one among them;
    bands of 30 and 50 rows, not multiples of 4): the kernel sums exact
    float64 products in float64 and rounds once, so it lies within one
    float32 ulp (2^-23, 1.2e-7) of each window's max|G| from the float64
    twin, beside the 1e-5 limit against the float32 twin."""
    k = _logcov_kernel_inputs(batch, cuda, cold=False)
    got, err, err64 = _gram_errors(k.yw, k.offsets)
    assert got.shape == (batch, 8 * 36) and torch.isfinite(got).all()
    assert err <= 1e-5 and err64 <= 1.2e-7


@pytest.mark.parametrize("layout", ["logcov", "logcov12", "16 bands"])
def test_band_grams_kernel_other_layouts_within_one_ulp(cuda, layout):
    """The broad 4-band layout, the 12-band one (R = 900) and 16 bands of
    1 to 61 rows, B = 37 Gaussian rows: within one float32 ulp of each
    window's max|G| from float64, and 1e-5 from the float32 twin."""
    offsets = _gram_layout(layout)
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((37, offsets[-1], C)).astype(np.float32)).to(cuda)
    got, err, err64 = _gram_errors(y, offsets)
    assert got.shape == (37, (len(offsets) - 1) * 36) and torch.isfinite(got).all()
    assert err <= 1e-5 and err64 <= 1.2e-7


def test_band_grams_lean_path_launches_the_kernel(cuda):
    """Under no_grad, and for rows that need no gradient, the wrapper skips
    the autograd Function but still launches the kernel (counted once a
    call), with the values of the launch through the Function; a bad
    layout raises after a good one was cached."""
    k = _logcov_kernel_inputs(37, cuda, cold=False)
    before = kernels.launches()["bandcov_grams"]
    with torch.no_grad():
        a = band_grams(k.yw.clone().requires_grad_(True), k.offsets)
    b = band_grams(k.yw, k.offsets)
    c = band_grams(k.yw.clone().requires_grad_(True), k.offsets)
    torch.cuda.synchronize()
    assert kernels.launches()["bandcov_grams"] == before + 3
    assert a.grad_fn is None and b.grad_fn is None and c.grad_fn is not None
    assert torch.equal(a, b) and torch.equal(b, c.detach())
    with pytest.raises(ValueError):
        band_grams(k.yw, k.offsets[:-1] + (451,))


@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("cold", [False, True])
def test_logcov_feats_kernel_matches_plain(cuda, batch, cold):
    """Features within 5e-5 of each window's max(scale, 1) (the JAX
    package's kernel-vs-stages limit, per window so that the railed
    window's large features do not loosen it for the others), flags equal:
    the guard's arithmetic is the twin's, op for op, with no FMA
    contraction."""
    k = _logcov_kernel_inputs(batch, cuda, cold)
    grams = band_grams_plain(k.yw, k.offsets)
    before = kernels.launches()["logcov_feats"]
    feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    torch.cuda.synchronize()
    assert kernels.launches()["logcov_feats"] == before + 1
    want, want_flags = logcov_feats_plain(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    assert feats.shape == (batch, 288) and flags.shape == (batch, 8) and flags.dtype == torch.bool
    assert torch.equal(flags, want_flags)
    if cold and batch >= 3:
        assert flags[0].all() and flags[2].any() and not flags.all()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert ((feats - want).abs() / scale).max().item() <= 5e-5


def _stieltjes_log_coeffs(lo, hi, terms):
    """c0, poles, weights of log x ~ c0 - sum_j t_j du / (x + t_j): the
    integral log x = int_0^inf (1 / (1 + t) - 1 / (x + t)) dt by the
    midpoint rule in u = log t on [log(lo / 16), log(16 hi)]. Every weight
    is negative and every term at most du in size, so the sum is as well
    conditioned as the log itself at any number of poles."""
    edges = np.linspace(np.log(lo / 16.0), np.log(16.0 * hi), terms + 1)
    du = np.diff(edges)
    t = np.exp(0.5 * (edges[:-1] + edges[1:]))
    return float(np.sum(du * t / (1.0 + t))), tuple(-t), tuple(-du * t)


@pytest.mark.parametrize("terms, fit", [(1, "lstsq"), (4, "lstsq"), (32, "stieltjes")])
def test_logcov_feats_kernel_pole_counts(cuda, terms, fit):
    """The one-thread-a-matrix route for 1, 4 and 32 poles (32 is the
    kernel's limit), guard firing: flags equal to the twin's, features
    within 5e-5 of each window's max(scale, 1). 1 and 4 poles are the
    model's least-squares fits; at 32 poles that fit is ill-conditioned
    (terms up to 1e3 cancel to a log of a few units, and the float32 twin
    itself is 1.3e-3 of scale from float64: see the next test), so 32 poles
    take a quadrature of the log's Stieltjes integral."""
    k = _logcov_kernel_inputs(37, cuda, cold=True)
    lo, hi = k.scalars["lo"], k.scalars["hi"]
    make = logcov._rational_log_coeffs if fit == "lstsq" else _stieltjes_log_coeffs
    c0, poles, weights = make(lo, hi, terms)
    coeffs = (c0,) + tuple(poles) + tuple(weights)
    grams = band_grams_plain(k.yw, k.offsets)
    feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, coeffs, **k.scalars)
    want, want_flags = logcov_feats_plain(grams, k.tr_scaled, k.wwt_pairs, coeffs, **k.scalars)
    torch.cuda.synchronize()
    assert torch.equal(flags, want_flags) and flags.any()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert torch.isfinite(feats).all()
    assert ((feats - want).abs() / scale).max().item() <= 5e-5


def test_logcov_feats_kernel_ill_conditioned_fit(cuda):
    """The model's 32-pole least-squares fit: kernel and twin round
    differently through terms that cancel by three orders, so they are held
    to float64 instead: flags equal, and the kernel's error of scale at
    most twice the twin's."""
    k = _logcov_kernel_inputs(37, cuda, cold=True)
    c0, poles, weights = logcov._rational_log_coeffs(k.scalars["lo"], k.scalars["hi"], 32)
    coeffs = (c0,) + tuple(poles) + tuple(weights)
    grams = band_grams_plain(k.yw, k.offsets)
    feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, coeffs, **k.scalars)
    want, want_flags = logcov_feats_plain(grams, k.tr_scaled, k.wwt_pairs, coeffs, **k.scalars)
    exact, _ = logcov_feats_plain(grams.double(), k.tr_scaled.double(), k.wwt_pairs.double(), coeffs, **k.scalars)
    torch.cuda.synchronize()
    assert torch.equal(flags, want_flags)
    scale = exact.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    kernel_err = ((feats.double() - exact).abs() / scale).max().item()
    twin_err = ((want.double() - exact).abs() / scale).max().item()
    assert kernel_err <= 2.0 * twin_err


def test_stages_path_runs_the_gram_kernel(cuda):
    """fused="stages" (and guard_domain=False) on a CUDA tensor still send
    the band grams through the gram kernel, as the JAX package sends them
    through its Pallas kernel on the TPU; the stages path agrees with the
    kernel route within 5e-5 of each window's max(scale, 1)."""
    cfg = get_model("logcov8", whiten=True, dropout=0.0).config
    w = torch.from_numpy(load_params_npz(REPO / "checkpoints" / "logcov8wd_ens_s0.npz")["whitener"]).to(cuda)
    x = mai_filter_batch(_windows(37, 5) / 40.0, FilterConfig(precision="fast"), device=cuda)
    want = logcov.logcov_features(x, cfg, w)
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    for kw in ({"fused": "stages"}, {"guard_domain": False}):
        kernels.reset_launches()
        got = logcov.logcov_features(x, dataclasses.replace(cfg, **kw), w)
        torch.cuda.synchronize()
        counts = kernels.launches()
        assert counts["bandcov_grams"] == 1 and counts["logcov_feats"] == 0
        assert ((got - want).abs() / scale).max().item() <= 5e-5


def test_logcov_kernels_reject_bad_input(cuda):
    k = _logcov_kernel_inputs(4, cuda, cold=False)
    with pytest.raises(TypeError):
        band_grams(k.yw.double(), k.offsets)
    with pytest.raises(ValueError):
        band_grams(k.yw[:, :, :4].contiguous(), k.offsets)
    with pytest.raises(ValueError):
        band_grams(k.yw, k.offsets[:-1] + (10**6,))
    with pytest.raises(ValueError):  # misaligned for the float4 loads
        band_grams(k.yw.reshape(-1)[1 : 1 + 3 * 450 * 8].view(3, 450, 8), k.offsets)
    grams = band_grams(k.yw, k.offsets)
    with pytest.raises(ValueError):
        logcov_feats(grams, k.tr_scaled.cpu(), k.wwt_pairs, k.coeffs, **k.scalars)
    with pytest.raises(TypeError):
        logcov_feats(grams.double(), k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    with pytest.raises(ValueError):
        logcov_feats(grams[:, :36].contiguous(), k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    assert band_grams(k.yw[:0], k.offsets).shape == (0, 288)


def test_flagship_ensemble_cuda_matches_cpu(cuda):
    """The flagship manifest on the card (all three kernels) against the
    same engine on the CPU (the twins): probabilities within 1e-4, equal
    guard counts."""
    x = _windows(16, 9) / 40.0
    kernels.reset_launches()
    gpu = EnsembleEngine.from_manifest(str(FLAGSHIP))
    got = gpu.predict_batch(x)
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert all(counts[name] == 1 for name in ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats"))
    cpu = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")
    assert np.abs(got - cpu.predict_batch(x)).max() <= 1e-4
    assert gpu.stats == cpu.stats


@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("cold", [False, True])
def test_logcov_feats_chebyshev_kernel_matches_plain(cuda, batch, cold):
    """Chebyshev mode: features within 5e-5 of each window's max(scale,
    1), flags equal to the twin's and to the rational mode's on the same
    grams (steps 1-2 are the same code), counted under its own name."""
    k = _logcov_kernel_inputs(batch, cuda, cold, logm="chebyshev")
    kr = _logcov_kernel_inputs(batch, cuda, cold)
    grams = band_grams_plain(k.yw, k.offsets)
    before = kernels.launches()
    feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["logcov_feats_chebyshev"] == before["logcov_feats_chebyshev"] + 1
    assert after["logcov_feats"] == before["logcov_feats"]
    want, want_flags = logcov_feats_plain(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    _, rational_flags = logcov_feats(grams, kr.tr_scaled, kr.wwt_pairs, kr.coeffs, **kr.scalars)
    assert feats.shape == (batch, 288) and flags.dtype == torch.bool
    assert torch.equal(flags, want_flags) and torch.equal(flags, rational_flags)
    if cold and batch >= 3:
        assert flags[0].all() and flags[2].any() and not flags.all()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert ((feats - want).abs() / scale).max().item() <= 5e-5


def _band_covariances(batch: int, dev):
    """Unwhitened logcov8 band covariances of random windows through the
    card's filter: [batch, 8, 8, 8], in the domain by the shrinkage floor."""
    cfg = get_model("logcov8").config
    x = mai_filter_batch(_windows(batch, batch + 200) / 40.0, FilterConfig(precision="fast"), device=dev)
    return logcov.band_covariances(x, cfg), cfg


@pytest.mark.parametrize("batch", [1, 37, 1024])
def test_logm_clenshaw_kernel_matches_plain(cuda, batch):
    """Degree 320 on in-domain spectra: <= 5e-5 absolute (the JAX
    package's kernel-vs-scan limit); the result is exactly symmetric."""
    s, cfg = _band_covariances(batch, cuda)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    before = kernels.launches()["logm_clenshaw"]
    got = logm_kernels.logm_spd_chebyshev(s, coeffs, lo, hi)
    torch.cuda.synchronize()
    assert kernels.launches()["logm_clenshaw"] == before + 1
    want = logm_kernels.logm_spd_chebyshev_plain(s, coeffs, lo, hi)
    assert got.shape == s.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-5
    assert torch.equal(got, got.transpose(-1, -2))


F64_RATIO = 2.0  # chip_smoke.py's limit on kernel / twin error against float64
CHEB_CASES = ("identity", "zero_window", "split", "at_lo")
CHEB_DEGREES = (0, 1, 2, 7, 320)


def _edge_matrices(case: str, lo: float) -> np.ndarray:
    """Four float64 [8, 8] matrices of an edge case of the eigendecomposition
    route: multiples of the identity (1 down to 5e-14, the shrinkage floor
    of a zero covariance), two eigenvalues 1e-7 apart (relative), the
    smallest trace-normalised eigenvalue at 1.001 lo (above the guard's
    edge). "zero_window" is the unwhitened all-zero window's matrix."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(4, C, C)))
    lam = rng.uniform(0.3, 3.0, size=(4, C))
    if case == "identity":
        return np.stack([c * np.eye(C) for c in (1.0, 3.7, 1e-3, 5e-14)])
    if case == "zero_window":
        return np.stack([get_model("logcov8").config.shrinkage * 1e-12 * np.eye(C)] * 4)
    if case == "split":
        lam[:, 1] = lam[:, 0] * (1.0 + 1e-7)
    if case == "at_lo":
        lam = lam / lam.sum(axis=1, keepdims=True) * C * (1.0 - 1.001 * lo / C)
        lam[:, 0] = 1.001 * lo
    return np.einsum("mij,mj,mkj->mik", q, lam, q)


def _feature_inputs(s: np.ndarray, dev):
    """Feature-kernel inputs for one window whose nb bands' shrunk matrices
    are s [nb, 8, 8]: shrinkage 0 (so the kernel's s is the gram pairs
    times scale), W W^T = I, the flagship's scale, domain and guard."""
    cfg = get_model("logcov8", **CHEB_KW).config
    lo, hi = cfg.cheb_interval
    scale = 2.0 / (T * T)
    iu, ju = np.triu_indices(C)
    grams = torch.from_numpy((s[:, iu, ju] / scale).reshape(1, -1).astype(np.float32)).to(dev)
    tr_scaled = torch.from_numpy(np.trace(s, axis1=1, axis2=2)[None].astype(np.float32)).to(dev)
    wwt = torch.from_numpy(np.tile(np.eye(C)[iu, ju], (s.shape[0], 1)).astype(np.float32)).to(dev)
    scalars = dict(scale=scale, alpha=0.0, lo=lo, hi=hi, guard_g=logcov._guard_strength(cfg), logm="chebyshev")
    return grams, tr_scaled, wwt, scalars


def _cheb_feats_vs_twin(grams, tr_scaled, wwt, coeffs, scalars):
    """(kernel feats, flags, twin feats, twin flags, float64 feats)."""
    feats, flags = logcov_feats(grams, tr_scaled, wwt, coeffs, **scalars)
    want, want_flags = logcov_feats_plain(grams, tr_scaled, wwt, coeffs, **scalars)
    exact, _ = logcov_feats_plain(grams.double(), tr_scaled.double(), wwt.double(), coeffs, **scalars)
    torch.cuda.synchronize()
    return feats, flags, want, want_flags, exact


@pytest.mark.parametrize("degree", CHEB_DEGREES)
@pytest.mark.parametrize("case", CHEB_CASES)
def test_logcov_feats_chebyshev_kernel_edge_cases(cuda, case, degree):
    """The feature kernel's eigendecomposition route (Chebyshev mode) on
    edge cases, the smoke's all-zero window under the cold whitener
    (guarded) among them, degrees 0 to 320: flags equal, features within
    5e-5 of each window's max(scale, 1) of the twin and of float64."""
    lo, hi = get_model("logcov8").config.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, degree)
    if case == "zero_window":
        k = _logcov_kernel_inputs(3, cuda, cold=True, logm="chebyshev")
        grams = band_grams_plain(k.yw, k.offsets)
        grams[1] = 0.0
        tr_scaled = k.tr_scaled.clone()
        tr_scaled[1] = 0.0
        inputs = (grams, tr_scaled, k.wwt_pairs, k.scalars)
    else:
        inputs = _feature_inputs(_edge_matrices(case, lo), cuda)
    grams, tr_scaled, wwt, scalars = inputs
    feats, flags, want, want_flags, exact = _cheb_feats_vs_twin(grams, tr_scaled, wwt, coeffs, scalars)
    assert torch.equal(flags, want_flags)
    assert torch.isfinite(feats).all()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert ((feats - want).abs() / scale).max().item() <= 5e-5
    assert ((feats.double() - exact).abs() / scale).max().item() <= 5e-5


@pytest.mark.parametrize("degree", CHEB_DEGREES)
@pytest.mark.parametrize("case", CHEB_CASES)
def test_logm_clenshaw_kernel_edge_cases(cuda, case, degree):
    """The Clenshaw kernel's eigendecomposition route on the same edge
    cases and degrees: within 5e-5 of the twin and of float64, exactly
    symmetric; degree 0 gives c_0 I exactly."""
    lo, hi = get_model("logcov8").config.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, degree)
    s64 = torch.from_numpy(_edge_matrices(case, lo)).to(cuda)
    s = s64.float()
    got = logm_kernels.logm_spd_chebyshev(s, coeffs, lo, hi)
    want = logm_kernels.logm_spd_chebyshev_plain(s, coeffs, lo, hi)
    exact = logm_kernels.logm_spd_chebyshev_plain(s.double(), coeffs, lo, hi)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, got.transpose(-1, -2))
    assert (got - want).abs().max().item() <= 5e-5
    assert (got.double() - exact).abs().max().item() <= 5e-5
    if degree == 0:
        t, _ = spd.chebyshev_domain_map(s, lo, hi)
        series = logm_kernels.clenshaw(t, coeffs)
        assert torch.equal(series, float(np.float32(coeffs[0])) * torch.eye(C, device=cuda).expand_as(series))


@pytest.mark.parametrize("matrices", [1, 33, 8197])
def test_logm_clenshaw_kernel_ragged_count(cuda, matrices):
    """M not a multiple of the 32-thread block: every matrix within 5e-5
    of the twin, none left unwritten (the output starts as NaN)."""
    s, cfg = _band_covariances(-(-matrices // 8), cuda)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    t, _ = spd.chebyshev_domain_map(s, lo, hi)
    t = t.reshape(-1, C, C)[:matrices].contiguous()
    lib = logm_kernels._library()
    out = torch.full_like(t, float("nan"))
    cbuf = logm_kernels.device_coeffs(tuple(float(c) for c in coeffs), cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.nsd_logm_clenshaw(t.data_ptr(), out.data_ptr(), matrices, cbuf.data_ptr(), len(coeffs) - 1, stream) == 0
    want = spd.clenshaw(t, coeffs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= 5e-5
    assert torch.equal(logm_kernels.clenshaw(t, coeffs), out)


@pytest.mark.parametrize("batch", [1, 5, 1025])
def test_logcov_feats_chebyshev_kernel_ragged_count(cuda, batch):
    """B x 8 matrices, not a multiple of the 32-thread block for B = 1, 5
    and 1025: every feature within the limit of the twin, flags equal."""
    k = _logcov_kernel_inputs(batch, cuda, cold=True, logm="chebyshev")
    grams = band_grams_plain(k.yw, k.offsets)
    feats, flags, want, want_flags, _ = _cheb_feats_vs_twin(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, k.scalars)
    assert torch.equal(flags, want_flags) and torch.isfinite(feats).all()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert ((feats - want).abs() / scale).max().item() <= 5e-5


def test_chebyshev_kernels_nan_matrix(cuda):
    """A NaN entry in one matrix: both kernels end (the QL iteration stops
    at its cap) and only that matrix's result is non-finite; the rest
    agree with the twins, and the flags equal the twin's (a NaN band is
    flagged)."""
    k = _logcov_kernel_inputs(37, cuda, cold=False, logm="chebyshev")
    grams = band_grams_plain(k.yw, k.offsets)
    grams[4, 3 * 36 + 8] = float("nan")  # window 4, band 3, entry (1, 1)
    feats, flags, want, want_flags, _ = _cheb_feats_vs_twin(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, k.scalars)
    assert torch.equal(flags, want_flags) and flags[4, 3]
    bad = ~torch.isfinite(feats.reshape(37, 8, 36))
    assert bad[4, 3].any() and bad.sum().item() == bad[4, 3].sum().item()
    ok = torch.isfinite(want)
    scale = want.nan_to_num(0.0).abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert ((feats - want).abs() / scale)[ok].max().item() <= 5e-5

    s, cfg = _band_covariances(37, cuda)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    s = s.clone()
    s[6, 2, 3, 3] = float("nan")
    got = logm_kernels.logm_spd_chebyshev(s, coeffs, lo, hi)
    want = logm_kernels.logm_spd_chebyshev_plain(s, coeffs, lo, hi)
    torch.cuda.synchronize()
    finite = torch.isfinite(got).reshape(-1, 64).all(dim=1)
    assert not finite[6 * 8 + 2] and finite.sum().item() == finite.numel() - 1
    assert (got - want).abs().reshape(-1, 64)[finite].max().item() <= 5e-5


@pytest.mark.parametrize("batch", [1, 37])
def test_chebyshev_kernels_float64_ratio(cuda, batch):
    """Against float64, each Chebyshev kernel errs at most twice as much as
    its float32 twin: the feature kernel on the cold whitener's inputs
    (eigenvalues near lo, the guard firing), the Clenshaw kernel on the
    unwhitened band covariances."""
    k = _logcov_kernel_inputs(batch, cuda, cold=True, logm="chebyshev")
    grams = band_grams_plain(k.yw, k.offsets)
    feats, _, want, _, exact = _cheb_feats_vs_twin(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, k.scalars)
    k64 = (feats.double() - exact).abs().max().item()
    p64 = (want.double() - exact).abs().max().item()
    assert k64 <= F64_RATIO * p64, (k64, p64)

    s, cfg = _band_covariances(batch, cuda)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    got = logm_kernels.logm_spd_chebyshev(s, coeffs, lo, hi)
    want = logm_kernels.logm_spd_chebyshev_plain(s, coeffs, lo, hi)
    exact = logm_kernels.logm_spd_chebyshev_plain(s.double(), coeffs, lo, hi)
    torch.cuda.synchronize()
    k64 = (got.double() - exact).abs().max().item()
    p64 = (want.double() - exact).abs().max().item()
    assert k64 <= F64_RATIO * p64, (k64, p64)


def test_iir_cascade_kernel_matches_plain(cuda):
    """The collector's 14 sections forward then reversed, B = 37: within
    3e-5 of each window's scale of the twin (chip_smoke.py states the
    limit), and within 1e-4 of the float64 twin (the scipy composite)."""
    x = torch.from_numpy(_windows(37, 11)).to(cuda)
    x = x - x.mean(dim=1, keepdim=True)
    sos = iir_kernels.stack_sos(iir_kernels.collector_stages())
    before = kernels.launches()["iir_cascade"]
    got = iir_kernels.iir_cascade(x, sos)
    torch.cuda.synchronize()
    assert kernels.launches()["iir_cascade"] == before + 1
    want = iir_kernels.iir_cascade_plain(x, sos)
    exact = iir_kernels.iir_cascade_plain(x.double(), sos)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() / scale).max().item() <= 3e-5
    assert ((got.double() - exact).abs() / scale).max().item() <= 1e-4
    out = iir_kernels.fused_preprocess(x, iir_kernels.collector_stages(), zscore=True)
    assert out.device.type == "cuda" and torch.isfinite(out).all()


IIR_TWIN_TOL = 3e-5  # chip_smoke.py's limit, of each window's max |twin|
IIR_SOS = iir_kernels.stack_sos(iir_kernels.collector_stages())  # 14 sections
IIR_LANES = (1, 2, 4, 8, 16)  # every G the kernel takes
# The plan's own shape (None), and each G forced in each shape (staged or not)
IIR_SHAPES = [(None, None), *[(g, True) for g in IIR_LANES], *[(g, False) for g in IIR_LANES]]


def _iir_sos(sections: int) -> np.ndarray:
    """`sections` stable sections: the collector's 14, repeated."""
    return np.ascontiguousarray(np.concatenate([IIR_SOS] * 3)[:sections])


def _iir_windows(batch: int, t_len: int, channels: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((batch, t_len, channels)) * 40.0).astype(np.float32)).to(dev)
    return x - x.mean(dim=1, keepdim=True)


def _iir_run(x, sos, lanes=None, staged=None):
    """The kernel once: the wrapper's plan (lanes None), or G = `lanes` in
    the staged or the global-memory shape."""
    if lanes is None:
        return iir_kernels.iir_cascade(x, sos)
    b, t, c = x.shape
    smem = iir_kernels.card_limits(x.device)[1]
    return iir_kernels._launch(x, sos, iir_kernels._shape(staged, lanes, b, t, c, sos.shape[0], smem))


def _iir_twins(x, sos, twin_device=None):
    """The twin and the float64 twin (the scipy composite) of x."""
    xt = x if twin_device is None else x.to(twin_device)
    return (iir_kernels.iir_cascade_plain(xt, sos).to(x.device),
            iir_kernels.iir_cascade_plain(xt.double(), sos).to(x.device))


@functools.lru_cache(maxsize=8)
def _iir_case(batch: int, sections: int):
    """Windows [batch, T, C] on the card and their two twins, made once for
    the tests that force each shape on them."""
    x = _iir_windows(batch, T, C, batch + sections, torch.device("cuda"))
    sos = _iir_sos(sections)
    return (x, sos, *_iir_twins(x, sos))


def _iir_check(x, sos, lanes=None, staged=None, twins=None, twin_device=None):
    """The kernel once (one launch counted) against the twin and the
    float64 twin: within IIR_TWIN_TOL of each window's scale of the twin,
    and at most F64_RATIO times the twin's error against float64."""
    before = kernels.launches()["iir_cascade"]
    got = _iir_run(x, sos, lanes, staged)
    torch.cuda.synchronize()
    assert kernels.launches()["iir_cascade"] == before + 1
    want, exact = twins or _iir_twins(x, sos, twin_device)
    scale = exact.abs().amax(dim=(1, 2), keepdim=True)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / scale).max().item() <= IIR_TWIN_TOL
    k64 = ((got.double() - exact).abs() / scale).max().item()
    p64 = ((want.double() - exact).abs() / scale).max().item()
    assert k64 <= F64_RATIO * p64, (k64, p64)
    return got


@pytest.mark.parametrize("lanes, staged", IIR_SHAPES)
@pytest.mark.parametrize("batch", [37, 1024, 3072])
def test_iir_cascade_kernel_each_lane_count(cuda, batch, lanes, staged):
    """Every G in both shapes, the collector's 14 sections; the plan's own
    (None) is staged at G = 2 at B = 37 and 1024 and in global memory at
    G = 1 at B = 3072 on an H100."""
    x, sos, want, exact = _iir_case(batch, 14)
    _iir_check(x, sos, lanes, staged, (want, exact))


@pytest.mark.parametrize("lanes, staged", IIR_SHAPES)
@pytest.mark.parametrize("sections", [1, 5, 32])
def test_iir_cascade_kernel_section_counts(cuda, sections, lanes, staged):
    """S = 1 (every G but 1 pads with identity slots), S = 5 (K = 7 slots
    at G = 1, 4 at G = 2: identity slots past ceil(S / G)) and S = 32
    (G = 1 would hold 32 sections a lane, over the kernel's 16: refused;
    the plan takes G = 2 for it in global memory)."""
    x, sos, want, exact = _iir_case(37, sections)
    if lanes is not None and -(-sections // lanes) > iir_kernels.MAX_SLOTS:
        with pytest.raises(ValueError, match="lanes"):
            _iir_run(x, sos, lanes, staged)
        return
    _iir_check(x, sos, lanes, staged, (want, exact))


def test_iir_cascade_kernel_refuses_33_sections(cuda):
    x = _iir_windows(2, T, C, 0, cuda)
    with pytest.raises(ValueError, match="limit"):
        iir_kernels.iir_cascade(x, np.concatenate([IIR_SOS] * 3)[:33])


@pytest.mark.parametrize("lanes", [None, 2, 8])
def test_iir_cascade_kernel_partial_block(cuda, lanes):
    """C = 5, B = 5, T = 97: blocks of W windows (W = 4 at G = 8) leave the
    last one partly empty, and a 485-float tile is no multiple of 16
    bytes, so the plain copy stages it."""
    x = _iir_windows(5, 97, 5, 3, cuda)
    assert iir_kernels.launch_plan(5, 97, 5, 14, *iir_kernels.card_limits(x.device)).staged
    _iir_check(x, IIR_SOS, lanes, True)


def test_iir_cascade_kernel_unaligned_input(cuda):
    """x 4 bytes past a 16-byte boundary: no bulk copy; the plain copy
    stages it."""
    x = _iir_windows(37, T, C, 5, cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(x.shape)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(_iir_check(shifted, IIR_SOS), _iir_check(x, IIR_SOS), rtol=0, atol=0)


def test_iir_cascade_kernel_past_shared_memory(cuda):
    """B = 1, T = 20000: a 640 KB window, over one block's shared memory,
    runs the lane pipeline in place in global memory. The twins run on the
    CPU (a loop over 20000 samples); 4 sections keep them short."""
    x = _iir_windows(1, 20000, C, 7, cuda)
    sos = _iir_sos(4)
    plan = iir_kernels.launch_plan(1, 20000, C, 4, *iir_kernels.card_limits(x.device))
    assert not plan.staged
    _iir_check(x, sos, twin_device="cpu")


@pytest.mark.parametrize("past", [0, 1])
def test_iir_cascade_kernel_at_the_edge_of_shared_memory(cuda, past):
    """The longest window at C = 8 whose tile and the kernel's own
    STATIC_SMEM bytes fit a block's opt-in shared memory (T = 7263 on an
    H100) stages; one sample more runs in global memory, and the kernel
    entry refuses that tile staged."""
    smem = iir_kernels.card_limits(cuda)[1]
    t_len = (smem - iir_kernels.STATIC_SMEM) // (4 * C) + past
    x = _iir_windows(1, t_len, C, 13, cuda)
    sos = _iir_sos(4)
    assert iir_kernels.launch_plan(1, t_len, C, 4, *iir_kernels.card_limits(cuda)).staged == (past == 0)
    _iir_check(x, sos, twin_device="cpu")
    if past:
        forced = iir_kernels.LaunchPlan(lanes=2, windows=1, block_series=C, blocks=1, threads=32,
                                        shared_bytes=4 * t_len * C, staged=True)
        with pytest.raises(RuntimeError, match="launch failed"):
            iir_kernels._launch(x, sos, forced)


@pytest.mark.parametrize("lanes, staged", [(None, None), (1, False), (16, True)])
def test_iir_cascade_kernel_nan_series(cuda, lanes, staged):
    """A NaN in one series makes that series NaN, as in the twin; its
    neighbours, in the same block and the same warp, stay finite and
    within the limit of the twin."""
    x = _iir_windows(37, T, C, 9, cuda)
    x[5, 300, 3] = float("nan")
    got = _iir_run(x, IIR_SOS, lanes, staged)
    want = iir_kernels.iir_cascade_plain(x, IIR_SOS)
    torch.cuda.synchronize()
    assert torch.isnan(got[5, :, 3]).all() and torch.isnan(want[5, :, 3]).all()
    keep = torch.ones_like(got, dtype=torch.bool)
    keep[5, :, 3] = False
    assert torch.isfinite(got[keep]).all()
    scale = want.nan_to_num(0.0).abs().amax(dim=(1, 2), keepdim=True).expand_as(want)
    assert ((got - want).abs()[keep] / scale[keep]).max().item() <= IIR_TWIN_TOL


def test_chebyshev_launch_counts(cuda):
    """logm="chebyshev" on a CUDA tensor: the kernel route (whitened) runs
    the feature kernel in Chebyshev mode, the stages path (unwhitened) the
    Clenshaw kernel; logm="chebyshev_scan" reaches neither."""
    x = mai_filter_batch(_windows(8, 21) / 40.0, FilterConfig(precision="fast"), device=cuda)
    w = torch.from_numpy(load_params_npz(REPO / "checkpoints" / "logcov8wd_ens_s0.npz")["whitener"]).to(cuda)
    cases = [
        (get_model("logcov8", **CHEB_KW).config, w, {"bandcov_grams": 1, "logcov_feats_chebyshev": 1}),
        (get_model("logcov8", logm="chebyshev").config, None, {"logm_clenshaw": 1}),
        (get_model("logcov8", whiten=True, logm="chebyshev", fused="stages").config, w,
         {"bandcov_grams": 1, "logm_clenshaw": 1}),
        (get_model("logcov8", logm="chebyshev_scan").config, None, {}),
        (get_model("logcov8", whiten=True, logm="chebyshev_scan").config, w, {"bandcov_grams": 1}),
    ]
    outs = []
    for cfg, whitener, counts in cases:
        kernels.reset_launches()
        outs.append(logcov.logcov_features(x, cfg, whitener))
        torch.cuda.synchronize()
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update(counts)
        assert kernels.launches() == want, (cfg.logm, cfg.fused, whitener is None)
    # the routes compute the same features
    assert (outs[0] - outs[2]).abs().max().item() <= 5e-5 * outs[2].abs().max().item()
    assert (outs[1] - outs[3]).abs().max().item() <= 5e-5 * outs[3].abs().max().item()


class _FailingLaunch:
    """A loaded library whose launch entry returns cudaErrorInvalidValue."""

    def __init__(self, lib, entry):
        self._lib, self._entry = lib, entry

    def __getattr__(self, name):
        if name == self._entry:
            return lambda *args: 1
        return getattr(self._lib, name)


def test_failed_launch_raises_and_does_not_fall_back(cuda, monkeypatch):
    """A CUDA tensor whose launch fails raises RuntimeError and counts
    nothing; it never takes the twin."""
    s, cfg = _band_covariances(4, cuda)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    lib = logm_kernels._library()
    monkeypatch.setattr(logm_kernels, "_library", lambda: _FailingLaunch(lib, "nsd_logm_clenshaw"))
    before = kernels.launches()
    with pytest.raises(RuntimeError, match="logm_clenshaw kernel launch failed"):
        logm_kernels.logm_spd_chebyshev(s, coeffs, lo, hi)
    x = torch.from_numpy(_windows(2, 3)).to(cuda)
    ilib = iir_kernels._library()
    monkeypatch.setattr(iir_kernels, "_library", lambda: _FailingLaunch(ilib, "nsd_iir_cascade"))
    with pytest.raises(RuntimeError, match="iir_cascade kernel launch failed"):
        iir_kernels.iir_cascade(x, iir_kernels.stack_sos(iir_kernels.collector_stages()))
    assert kernels.launches() == before
    with pytest.raises(ValueError, match="limit"):
        logm_kernels.clenshaw(s.reshape(-1, 8, 8), tuple(range(5000)))
    with pytest.raises(ValueError, match="limit"):
        iir_kernels.iir_cascade(x, np.zeros((40, 6)))


def test_chebyshev_flagship_cuda_matches_cpu(cuda):
    """The flagship served with logm="chebyshev" on the card against the
    same engine on the CPU: probabilities within 1e-4, equal guard
    counts."""
    x = _windows(16, 9) / 40.0
    gpu = EnsembleEngine.from_manifest(str(FLAGSHIP), model_kw=CHEB_KW)
    got = gpu.predict_batch(x)
    cpu = EnsembleEngine.from_manifest(str(FLAGSHIP), model_kw=CHEB_KW, device="cpu")
    assert np.abs(got - cpu.predict_batch(x)).max() <= 1e-4
    assert gpu.stats == cpu.stats


def test_eigh_backend_beyond_the_solver_batch(cuda):
    """logm="eigh" on the card: cuSOLVER's batched eigh refuses 32768
    8x8 matrices and more, so spd.logm_eigh goes in chunks; 40000
    matrices (5000 windows of 8 bands) agree with the CPU within 1e-4."""
    from neural_speech_decoding_tpu_torch.ops import spd

    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(40000, 8, 8)))
    lam = rng.uniform(0.1, 5.0, size=(40000, 8))
    a = torch.from_numpy(np.einsum("mij,mj,mkj->mik", q, lam, q).astype(np.float32))
    got = spd.logm_eigh(a.to(cuda).reshape(5000, 8, 8, 8))
    assert got.shape == (5000, 8, 8, 8)
    want = torch.from_numpy(np.einsum("mij,mj,mkj->mik", q, np.log(lam), q)).float()
    assert (got.cpu().reshape(-1, 8, 8) - want).abs().max().item() <= 1e-4


def _board_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8] (runtime/board.SyntheticBoard's
    sinusoids, slow modulation and noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    return (x + 0.35 * rng.standard_normal((n, T, C))).astype(np.float32)


def _family_source(checkpoint):
    from neural_speech_decoding_tpu_torch.models.lru import random_lru_params

    if checkpoint is None:
        return {"params": random_lru_params(seed=0)}
    return {"model_path": str(REPO / "checkpoints" / f"{checkpoint}.npz")}


@pytest.mark.parametrize("family, checkpoint", [
    ("eegnet", "eegnet3_best"),
    ("tcn", "tcn3_deploy"),
    ("transformer", "transformer3_best"),
    ("eegnet5", "eegnet5_best"),
    ("lru", None),
])
def test_family_engine_cuda_matches_cpu(cuda, family, checkpoint):
    """Each family of slice 4 through InferenceEngine on the card: one
    pair-sums launch and no other kernel a call, logits within 1e-4 of the
    same engine on the CPU with equal argmax."""
    x = _board_windows(37, 4)
    gpu = InferenceEngine(model=family, **_family_source(checkpoint))
    before = kernels.launches()
    got = gpu.logits_batch(x)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["kuramoto_pair_sums"] == before["kuramoto_pair_sums"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want = InferenceEngine(model=family, device="cpu", **_family_source(checkpoint)).logits_batch(x)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


MIX = [f"logcov8wd_ens_s{i}" for i in range(5)] + ["tcn3_best", "eegnet3_best", "transformer3_best"]


def test_mixed_ensemble_launch_counts(cuda):
    """The flagship members with a TCN, an EEGNet and a transformer in one
    EnsembleEngine: the filter, the band grams and the feature kernel
    exactly once a call; probabilities within 1e-4 of the CPU engine,
    equal argmax and guard counts."""
    kw = dict(model="logcov8", families=["logcov8"] * 5 + ["tcn", "eegnet", "transformer"],
              model_kw={"logcov8:whiten": True, "logcov8:dropout": 0.0})
    paths = [str(REPO / "checkpoints" / f"{m}.npz") for m in MIX]
    x = _board_windows(37, 6)
    x[3] = 0.0
    gpu = EnsembleEngine(paths, **kw)
    kernels.reset_launches()
    got = gpu.predict_batch(x)
    torch.cuda.synchronize()
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update(kuramoto_pair_sums=1, bandcov_grams=1, logcov_feats=1)
    assert kernels.launches() == want_launches
    cpu = EnsembleEngine(paths, device="cpu", **kw)
    want = cpu.predict_batch(x)
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert gpu.stats == cpu.stats
    assert gpu.logits_batch(x[:2]).shape == (8, 2, 3)


@pytest.mark.parametrize("samples, max_batch", [(625 + 125 * 99, 32), (625 + 125 * 31, 32), (625, 4096)])
def test_decode_recording_chunking(cuda, samples, max_batch):
    """decode_recording on the card: one pair-sums launch a chunk of
    max_batch windows (100 windows in 4 chunks, 32 in 1, a one-window
    recording), probabilities within 1e-4 of the CPU engine, start times
    equal."""
    rng = np.random.default_rng(samples)
    rec = (np.sin(np.arange(samples)[:, None] * 0.3 + np.arange(C)) + 0.3 * rng.standard_normal((samples, C)))
    rec = rec.astype(np.float32)
    path = str(REPO / "checkpoints" / "tcn3_deploy.npz")
    gpu = InferenceEngine(path, model="tcn")
    n = (samples - T) // 125 + 1
    before = kernels.launches()["kuramoto_pair_sums"]
    got, starts = gpu.decode_recording(rec, hop_seconds=1.0, max_batch=max_batch)
    torch.cuda.synchronize()
    assert kernels.launches()["kuramoto_pair_sums"] == before + -(-n // max_batch)
    want, want_starts = InferenceEngine(path, model="tcn", device="cpu").decode_recording(
        rec, hop_seconds=1.0, max_batch=max_batch
    )
    assert got.shape == (n, 3) and np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(starts, want_starts)
    assert gpu.stats["windows"] == n


def test_predict_batch_async_parks_flags(cuda):
    """predict_batch_async on the card returns a device tensor and leaves
    the guard flags parked (a device tensor each) until stats is read;
    then stats agree with predict_batch's on the CPU."""
    path = str(REPO / "checkpoints" / "logcov8w_deploy_s0.npz")
    kw = dict(model="logcov8", model_kw={"whiten": True})
    gpu = InferenceEngine(path, **kw)
    x = torch.from_numpy(_board_windows(16, 8)).to(cuda)
    out = [gpu.predict_batch_async(x) for _ in range(3)]
    assert all(o.is_cuda and o.shape == (16, 3) for o in out)
    assert len(gpu._parked) == 3 and all(f.is_cuda for f, _ in gpu._parked)
    assert gpu._stats == {"windows": 0, "guard_flagged": 0}
    cpu = InferenceEngine(path, device="cpu", **kw)
    want = cpu.predict_batch(x.cpu().numpy())
    assert np.abs(out[0].cpu().numpy() - want).max() <= 1e-4
    for _ in range(2):
        cpu.predict_batch(x.cpu().numpy())
    assert gpu.stats == cpu.stats and not gpu._parked


# ---------------------------------------------------------------------------
# training on the card (slice 5)
# ---------------------------------------------------------------------------
def _golden_windows(n: int) -> np.ndarray:
    with np.load(REPO / "tests" / "golden" / "reference_filtered.npz", allow_pickle=False) as z:
        return z["filtered"][:n]


def _grad_of(fn, x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    xr = x.detach().clone().requires_grad_(True)
    out = fn(xr)
    (out[0] if isinstance(out, tuple) else out).backward(ct)
    return xr.grad


def test_kernel_routes_backward_on_cuda(cuda):
    """Gradients flow through band_grams, logm_spd_chebyshev and the logcov
    kernel route on CUDA tensors: each forward launches its kernel (counted)
    and each backward recomputes through its twin, so the gradient equals
    the twin's own to rounding (1e-5 of its max)."""
    cfg = get_model("logcov8", whiten=True, dropout=0.0).config
    x = torch.from_numpy(_golden_windows(32)).to(cuda)
    w0 = logcov.fit_whitener(logcov.init_logcov_params(torch.Generator(device=cuda), cfg), x, cfg=cfg)["whitener"]
    k = logcov.kernel_inputs(x, w0, cfg)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    s = logcov.band_covariances(x, dataclasses.replace(cfg, whiten=False))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for counter, kernel_fn, twin_fn, inp in (
        ("bandcov_grams", lambda v: band_grams(v, k.offsets), lambda v: band_grams_plain(v, k.offsets), k.yw),
        ("logm_clenshaw", lambda v: logm_kernels.logm_spd_chebyshev(v, coeffs, lo, hi),
         lambda v: spd.logm_chebyshev(v, coeffs, lo, hi), s),
        ("logcov_feats", lambda v: logcov._fused_kernel_feats(v, w0, cfg),
         lambda v: logcov._stages_feats_reference(v, w0, cfg), x),
    ):
        with torch.no_grad():
            ct = torch.randn(twin_fn(inp).shape, generator=gen, device=cuda)
        before = kernels.launches()[counter]
        got = _grad_of(kernel_fn, inp, ct)
        assert kernels.launches()[counter] >= before + 1, counter
        want = _grad_of(twin_fn, inp, ct)
        assert got.is_cuda and torch.isfinite(got).all(), counter
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, counter


def test_lstm_gradients_cuda_match_cpu(cuda):
    """One full-width LSTM (hidden 48, 2 layers) loss gradient on 8 golden
    windows cut to T = 125, deterministic train mode, card against CPU:
    every leaf within 1e-4 of max(1, max|g|), the CPU parity budget."""
    from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
    from neural_speech_decoding_tpu_torch.train.loop import _leaves, _loss_fn

    spec = get_model("lstm", dropout=0.0, rrelu_lower=0.2, rrelu_upper=0.2)
    init = spec.init(torch.Generator().manual_seed(0))
    x = _golden_windows(8)[:, :125]
    y = np.arange(8) % 3

    def grads(dev):
        p = params_from_jax(init, dev)
        leaves = [t.requires_grad_(True) for _, t in _leaves(p)]
        loss, _ = _loss_fn(p, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), torch.Generator(device=dev),
                           spec.apply, 0.1, (1.0, 2.0, 0.5))
        return [g.cpu().numpy() for g in torch.autograd.grad(loss, leaves)]

    for g, c in zip(grads(cuda), grads(torch.device("cpu"))):
        assert np.abs(g - c).max() <= 1e-4 * max(1.0, float(np.abs(c).max()))


def test_train_on_cuda_by_default(cuda):
    """train() with no device trains on the card: the flagship recipe's
    family on 60 golden trials (the band-gram and feature kernels featurize
    both splits), the loss falls, and the parameters stay on the card."""
    from neural_speech_decoding_tpu_torch.config import THREE_CLASS_PREFIXES
    from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset
    from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, _leaves, train

    with np.load(REPO / "tests" / "golden" / "reference_filtered.npz", allow_pickle=False) as z:
        files = [str(f) for f in z["files"]]
        keep = [i for i, f in enumerate(files) if f.split("_")[0] in THREE_CLASS_PREFIXES][::3]
        windows = z["filtered"][keep]
    labels = np.asarray([THREE_CLASS_PREFIXES.index(files[i].split("_")[0]) for i in keep], np.int32)
    ds = TrialDataset(windows, labels, THREE_CLASS_PREFIXES, tuple(files[i] for i in keep))
    kernels.reset_launches()
    params, hist = train(ds, model="logcov8", model_kw={"whiten": True, "dropout": 0.0},
                         train_cfg=TrainConfig(epochs=10, batch_size=16, label_smoothing=0.1, augment_prob=0.5),
                         preprocessed=windows, verbose=False)
    launches = kernels.launches()
    assert launches["bandcov_grams"] >= 2 and launches["logcov_feats"] >= 2
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert all(t.is_cuda for _, t in _leaves(params))


def test_turbo_and_depth_on_cuda(cuda):
    """The per-layer recurrence on the card: the bfloat16 turbo engine
    keeps the float32 argmax on board-like windows, within JAX's documented
    turbo-vs-f32 figure (2.6e-1); a three-layer decoder agrees with the
    CPU within 1e-4."""
    from neural_speech_decoding_tpu_torch.config import DecoderConfig
    from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
    from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits, init_decoder_params

    path = str(REPO / "checkpoints" / "lstm3_retrained.npz")
    x = _board_windows(16, 3)
    f32 = InferenceEngine(path).logits_batch(x)
    turbo = InferenceEngine(path, turbo=True).logits_batch(x)
    np.testing.assert_array_equal(turbo.argmax(1), f32.argmax(1))
    assert np.abs(turbo - f32).max() <= 2.6e-1
    cfg = DecoderConfig(num_layers=3)
    p = init_decoder_params(torch.Generator().manual_seed(2), cfg)
    xf = torch.from_numpy(_golden_windows(8))
    gpu = decoder_logits(params_from_jax(p, cuda), xf.to(cuda), cfg).cpu().numpy()
    cpu = decoder_logits(p, xf, cfg).numpy()
    assert np.abs(gpu - cpu).max() <= 1e-4


def _recording_ct(t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = np.arange(t) / 125.0
    x = np.sin(2 * np.pi * (8 + np.arange(C))[:, None] * ts + rng.uniform(0, 2 * np.pi, (C, 1)))
    return 20.0 * (x + 0.35 * rng.standard_normal((C, t)))


def test_filter_surface_float64_cuda_matches_cpu(cuda):
    """The float64 surface on the card against the CPU, within 1e-9 of the
    largest |value|: the operator from phases and from the analytic signal,
    the phases, and the estimator (float64 work, float32 output)."""
    from neural_speech_decoding_tpu_torch.ops import hilbert, kuramoto

    x_ct = _recording_ct(625 * 4, 1)
    x = torch.from_numpy(x_ct.T.copy())
    for fn in (hilbert.instantaneous_phase,):
        got, want = fn(x.to(cuda), dim=0).cpu(), fn(x, dim=0)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-9
    phases = hilbert.instantaneous_phase(x, dim=0)
    got, want = kuramoto.kuramoto_operator(phases.to(cuda)).cpu(), kuramoto.kuramoto_operator(phases)
    assert got.dtype == torch.float64 and ((got - want).abs().max() / want.abs().max()).item() <= 1e-9
    z = hilbert.analytic_signal(x, dim=0)
    got = kuramoto.kuramoto_operator_from_analytic(z.to(cuda)).cpu()
    want = kuramoto.kuramoto_operator_from_analytic(z)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-9
    for lambd in (1e-25, 1e-34):
        got = kuramoto.KuramotoSpatialFilter(lambd=lambd).fit_transform(x_ct)
        want = kuramoto.KuramotoSpatialFilter(lambd=lambd, device="cpu").fit_transform(x_ct)
        assert got.dtype == np.float64 and np.abs(got - want).max() / np.abs(want).max() <= 1e-9


def test_device_trace_names_the_kernels(cuda, tmp_path):
    """A traced predict_batch of the flagship names the pair-sums, gram and
    feature kernels inside the annotated range."""
    import json as _json

    from neural_speech_decoding_tpu_torch.utils.tracing import TRACE_FILE, annotate, device_trace

    engine = EnsembleEngine.from_manifest(str(FLAGSHIP))
    x = _board_windows(64, 5)
    engine.predict_batch(x)
    with device_trace(str(tmp_path)) as log_dir, annotate("predict"):
        engine.predict_batch(x)
    events = _json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    for kernel in ("pair_sums_kernel", "band_grams_kernel", "logcov_feats_kernel"):
        assert any(kernel in n for n in names), (kernel, sorted(names)[:20])
    assert log_dir == str(tmp_path) and any(e.get("name") == "predict" for e in events)


def test_fit_ensemble_served_on_cuda(cuda, tmp_path, monkeypatch):
    """fit_ensemble on the card (K=2, logcov8 whitened, 2 epochs) on
    synthetic trial CSVs; its manifest served on the card against the CPU
    within 1e-5 of probability."""
    from neural_speech_decoding_tpu_torch.collector.chain import write_trial_csv
    from neural_speech_decoding_tpu_torch.tools.fit_ensemble import fit_ensemble

    trials = tmp_path / "trials"
    for i, w in enumerate(_board_windows(24, 9)):
        write_trial_csv(trials / f"{('food', 'water', 'backgroundnoise')[i % 3]}_{i:03d}.csv", w)
    monkeypatch.setenv("NSD_DATA_DIR", str(trials))
    kernels.reset_launches()
    manifest = fit_ensemble(str(tmp_path / "ens"), model="logcov8", seeds=2, epochs=2,
                            model_kw={"whiten": True, "dropout": 0.0}, verbose=False)
    assert kernels.launches()["kuramoto_pair_sums"] == 1 and kernels.launches()["bandcov_grams"] >= 2
    x = _board_windows(16, 10)
    got = EnsembleEngine.from_manifest(manifest).predict_batch(x)
    want = EnsembleEngine.from_manifest(manifest, device="cpu").predict_batch(x)
    assert np.abs(got - want).max() <= 1e-5
