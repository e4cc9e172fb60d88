"""Port parity: the Chebyshev matrix log and logcov's other backends of
neural_speech_decoding_tpu_torch against the JAX package on the CPU.

- ops/spd.logm_chebyshev (the twin of both Chebyshev kernels) against the
  JAX scan _logm_spd_chebyshev and the Pallas Clenshaw kernel in interpret
  mode;
- the kernel route in Chebyshev mode (the gram and feature twins) against
  the JAX fused kernel in interpret mode;
- logcov_apply_ex with logm chebyshev, chebyshev_scan, eigh and
  spectral="fft" on three shipped checkpoints;
- the flagship EnsembleEngine served with logm="chebyshev".

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU; each is called once per module.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models import logcov as jlc
from neural_speech_decoding_tpu.models import registry as jreg
from neural_speech_decoding_tpu.ops.pallas.logm import logm_spd_chebyshev_pallas
from neural_speech_decoding_tpu.runtime.ensemble import EnsembleEngine as JaxEnsembleEngine
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models import logcov as tlc
from neural_speech_decoding_tpu_torch.models import registry as treg
from neural_speech_decoding_tpu_torch.ops import spd
from neural_speech_decoding_tpu_torch.ops.kernels.logm import clenshaw, logm_spd_chebyshev
from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import logcov_feats
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"
FLAGSHIP = CKPT / "logcov8wd_ens_manifest.json"
CHEB_KW = {"whiten": True, "dropout": 0.0, "logm": "chebyshev"}
LOGIT_TOL = 1e-4  # the JAX package's f32 fidelity budget
LOGM_TOL = 5e-5  # the JAX package's kernel-vs-scan limit (tests/test_pallas_logm.py:66)
PROB_TOL = 1e-5  # as tests/test_torch_ensemble.py holds the rational flagship
T, C = 625, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def filtered():
    with np.load(GOLDEN, allow_pickle=False) as z:
        x = z["filtered"]
    return x[np.linspace(0, len(x) - 1, 64).astype(int)].astype(np.float32)


def _configs(family, **kw):
    jcfg = jreg.get_model(family, **kw).config
    tcfg = treg.get_model(family, **kw).config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _random_spd(m, lo, hi, seed=0):
    """m random SPD matrices with spectrum uniform in [lo, hi] (as
    tests/test_pallas_logm.py:18-24)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(m, C, C)))
    lam = rng.uniform(lo, hi, size=(m, C))
    return np.einsum("mij,mj,mkj->mik", q, lam, q).astype(np.float32)


def _guard_inputs(filtered):
    """Four golden windows, 0 with channel 2 railed and 3 with channel 5 a
    near-flatline, and the shipped whitener with its channel-5 gain cut
    tenfold ("cold5"), under which the guard fires for windows 0 and 3 (as
    tests/test_torch_logcov.py builds them)."""
    x = filtered[[10, 20, 30, 40]].copy()
    x[0, :, 2] *= 1e6
    x[3, :, 5] = 0.002 * np.sin(np.arange(T, dtype=np.float32) * 0.3)
    w = jax_load_npz(CKPT / "logcov8wd_ens_s0.npz")["whitener"]
    cold5 = w * np.where(np.arange(C) == 5, 0.1, 1.0).astype(np.float32)[None, None, :]
    return x, cold5.astype(np.float32)


@pytest.fixture(scope="module")
def fused_chebyshev_reference(filtered):
    """The JAX fused kernel in Chebyshev mode (interpret mode), once: about
    half a minute on one CPU core."""
    jcfg, _ = _configs("logcov8", **CHEB_KW)
    x, w = _guard_inputs(filtered)
    feats, flags = jlc._fused_kernel_feats(jnp.asarray(x), jnp.asarray(w), jcfg, True)
    return x, w, np.asarray(feats), np.asarray(flags)


@pytest.mark.parametrize("degree", [64, 320])
def test_chebyshev_coefficients_equal_jax(degree):
    lo, hi = tlc.LogCovConfig().cheb_interval
    got = tlc._cheb_log_coeffs(lo, hi, degree)
    assert len(got) == degree + 1
    assert got == jlc._cheb_log_coeffs(lo, hi, degree)


@pytest.mark.parametrize("m", [8, 515])
def test_logm_chebyshev_matches_jax_scan_and_pallas(m):
    """spd.logm_chebyshev (and the Clenshaw wrapper on the CPU, which takes
    it) against the JAX scan and the Pallas kernel in interpret mode, at
    degree 320 on spectra in [0.1, 7]: <= 5e-5."""
    cfg = tlc.LogCovConfig()
    lo, hi = cfg.cheb_interval
    coeffs = tlc._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    a = _random_spd(m, 0.1, 7.0, seed=m)
    scan = np.asarray(jlc._logm_spd_chebyshev(jnp.asarray(a), cfg))
    pallas = np.asarray(logm_spd_chebyshev_pallas(jnp.asarray(a), coeffs, lo, hi, interpret=True))
    got = spd.logm_chebyshev(torch.from_numpy(a), coeffs, lo, hi)
    assert got.shape == (m, C, C) and got.dtype == torch.float32
    assert np.abs(got.numpy() - scan).max() <= LOGM_TOL
    assert np.abs(got.numpy() - pallas).max() <= LOGM_TOL
    assert torch.equal(logm_spd_chebyshev(torch.from_numpy(a), coeffs, lo, hi), got)


def test_clenshaw_wrapper_contract():
    """Leading dimensions round-trip, the result is symmetric, the degree-0
    series is c_0 I, and bad input raises."""
    lo, hi = 0.002, 8.0
    coeffs = tlc._cheb_log_coeffs(lo, hi, 64)
    s = torch.from_numpy(_random_spd(12, 0.2, 5.0, seed=2)).reshape(3, 4, C, C)
    out = logm_spd_chebyshev(s, coeffs, lo, hi)
    assert out.shape == (3, 4, C, C)
    assert (out - out.transpose(-1, -2)).abs().max().item() <= 1e-5
    t = torch.zeros(2, C, C)
    assert torch.equal(clenshaw(t, coeffs[:1]), float(np.float32(coeffs[0])) * torch.eye(C).expand(2, C, C))
    with pytest.raises(TypeError):
        logm_spd_chebyshev(s.double(), coeffs, lo, hi)
    with pytest.raises(ValueError):
        logm_spd_chebyshev(s[..., :4], coeffs, lo, hi)
    with pytest.raises(ValueError):
        clenshaw(s, coeffs)  # [3, 4, 8, 8]: the kernel takes [M, 8, 8]


def test_kernel_route_chebyshev_matches_fused_kernel_interpret(fused_chebyshev_reference):
    """The kernel route in Chebyshev mode on the CPU (gram twin, then the
    feature twin in Chebyshev mode) against the JAX fused kernel in
    interpret mode, under the whitener that fires the guard: features
    within 5e-5 of each window's max(scale, 1), window flags equal."""
    x, w, want, want_flags = fused_chebyshev_reference
    _, tcfg = _configs("logcov8", **CHEB_KW)
    got, got_flags = tlc._fused_kernel_feats(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    assert got.shape == want.shape == (4, 288)
    np.testing.assert_array_equal(got_flags.numpy(), want_flags)
    assert want_flags[0] and want_flags[3] and not want_flags.all()
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(got.numpy() - want) / scale).max() <= 5e-5


def test_chebyshev_mode_flags_equal_rational_mode(fused_chebyshev_reference):
    """Steps 1-2 (shrinkage and guard) are the same in both modes: the
    per-band flags of the feature twin agree bit for bit, and the
    Chebyshev features agree with the stages path (fused="stages") within
    1e-6 of their scale."""
    x, w, _, _ = fused_chebyshev_reference
    _, tcfg = _configs("logcov8", **CHEB_KW)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    k = tlc.kernel_inputs(xt, wt, tcfg)
    kr = tlc.kernel_inputs(xt, wt, dataclasses.replace(tcfg, logm="rational"))
    assert k.scalars["logm"] == "chebyshev" and len(k.coeffs) == 321
    grams = tlc.band_grams(k.yw, k.offsets)
    feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
    _, rflags = logcov_feats(grams, kr.tr_scaled, kr.wwt_pairs, kr.coeffs, **kr.scalars)
    assert torch.equal(flags, rflags) and flags.any() and not flags.all()
    stages = tlc.logcov_features(xt, dataclasses.replace(tcfg, fused="stages"), wt)
    assert (feats - stages).abs().max().item() <= 1e-6 * stages.abs().max().item()
    with pytest.raises(ValueError, match="mode"):
        logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **dict(k.scalars, logm="pade"))


@pytest.mark.parametrize("backend", [
    {"logm": "chebyshev"},
    {"logm": "chebyshev_scan"},
    {"logm": "eigh"},
    {"spectral": "fft"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize(
    "checkpoint, family, kw",
    [
        ("logcov8wd_ens_s0", "logcov8", {"whiten": True, "dropout": 0.0}),
        ("logcov8_ens_s0", "logcov8", {}),
        ("logcov8_5_wd_ens_s0", "logcov8_5", {"whiten": True, "dropout": 0.0}),
    ],
)
def test_logcov_apply_ex_backends_match_jax(filtered, checkpoint, family, kw, backend):
    """64 golden windows through features, guard and head with each of
    logcov's other backends: <= 1e-4 max |delta logit|, equal argmax,
    equal guard flags."""
    jcfg, tcfg = _configs(family, **kw, **backend)
    want, want_aux = jlc.logcov_apply_ex(jax_load_npz(CKPT / f"{checkpoint}.npz"), jnp.asarray(filtered), jcfg)
    want = np.asarray(want)
    params = params_from_jax(load_params_npz(CKPT / f"{checkpoint}.npz"))
    got, aux = tlc.logcov_apply_ex(params, torch.from_numpy(filtered), tcfg)
    assert got.shape == (64, tcfg.num_classes) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))
    np.testing.assert_array_equal(aux["domain_flags"].numpy(), np.asarray(want_aux["domain_flags"]))


def _raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows (tests/test_torch_ensemble.py), window 3 all
    zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    x[3] = 0.0
    return x.astype(np.float32)


def test_chebyshev_flagship_engine_matches_jax():
    """The flagship manifest served with logm="chebyshev" (the CLI's
    --model-kw logm=chebyshev keeps whitening: it keys off the checkpoint)
    end to end on 20 raw windows: probabilities within 1e-5, equal argmax,
    equal stats."""
    windows = _raw_windows(20, 11)
    jax_engine = JaxEnsembleEngine.from_manifest(str(FLAGSHIP), model_kw=CHEB_KW)
    engine = EnsembleEngine.from_manifest(str(FLAGSHIP), model_kw=CHEB_KW, device="cpu")
    assert engine._spec.config.logm == "chebyshev" and engine._shared_featurize
    want = jax_engine.predict_batch(windows)
    got = engine.predict_batch(windows)
    assert got.shape == (20, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert engine.stats == jax_engine.stats


def test_logm_eigh_in_chunks_equals_one_call(monkeypatch):
    """spd.logm_eigh splits large batches (cuSOLVER's batched eigh on the
    card refuses 32768 matrices and more); chunked and whole agree exactly
    on the CPU, and an empty batch passes through."""
    s = torch.from_numpy(_random_spd(30, 0.1, 7.0, seed=3)).reshape(3, 10, C, C)
    whole = spd.logm_eigh(s)
    monkeypatch.setattr(spd, "EIGH_BATCH", 7)
    assert torch.equal(spd.logm_eigh(s), whole)
    assert spd.logm_eigh(s[:0]).shape == (0, 10, C, C)
