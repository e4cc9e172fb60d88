"""Port parity: the log-covariance family of neural_speech_decoding_tpu_torch
(models/logcov.py, the gram kernel's and the feature kernel's plain twins,
models/registry.py) against the JAX package on the CPU.

Inputs are the golden filtered windows of tests/golden/reference_filtered.npz
and the shipped logcov checkpoints. The JAX Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU.
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
from neural_speech_decoding_tpu.ops.pallas.bandcov import band_grams as jax_band_grams
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models import logcov as tlc
from neural_speech_decoding_tpu_torch.models import registry as treg
from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams
from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import logcov_feats

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"
LOGIT_TOL = 1e-4  # the JAX package's f32 fidelity budget


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
    # 64 windows spread over the whole set (all classes of the recording)
    return x[np.linspace(0, len(x) - 1, 64).astype(int)].astype(np.float32)


def _configs(family, **kw):
    """The same configuration in both packages."""
    jcfg = jreg.get_model(family, **kw).config
    tcfg = treg.get_model(family, **kw).config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _guard_inputs(filtered):
    """Four golden windows: 0 with channel 2 railed (x1e6), 3 with channel
    5 a near-flatline (0.002 sin), as in tests/test_logmfeats_fused.py.
    The shipped whiteners are well conditioned (cond(W W^T) <= 21), which
    keeps every trace-normalised eigenvalue above about 0.0025 > lo, so no
    input fires the guard under them. The second whitener is the shipped
    one with its gain on channel 5 cut tenfold (as if fitted on a recording
    where channel 5 ran ten times hotter): under it the guard fires for
    windows 0 and 3, and not for every window."""
    x = filtered[[10, 20, 30, 40]].copy()
    x[0, :, 2] *= 1e6
    x[3, :, 5] = 0.002 * np.sin(np.arange(625, dtype=np.float32) * 0.3)
    w = jax_load_npz(CKPT / "logcov8wd_ens_s0.npz")["whitener"]
    cold5 = w * np.where(np.arange(8) == 5, 0.1, 1.0).astype(np.float32)[None, None, :]
    return x, {"shipped": w, "cold5": cold5.astype(np.float32)}


@pytest.mark.parametrize("family", ["logcov", "logcov8", "logcov12"])
def test_projector_and_coefficients_equal_jax(family):
    jcfg, tcfg = _configs(family)
    jproj, jsl = jlc._band_projector(625, jcfg)
    tproj, tsl = tlc._band_projector(625, tcfg)
    np.testing.assert_array_equal(tproj, jproj)
    assert tproj.dtype == np.float32 and tsl == jsl
    lo, hi = tcfg.cheb_interval
    assert tlc._rational_log_coeffs(lo, hi, tcfg.logm_terms) == jlc._rational_log_coeffs(lo, hi, jcfg.logm_terms)
    assert tlc._num_features(tcfg) == jlc._num_features(jcfg)
    assert tlc._guard_strength(tcfg) == jlc._guard_strength(jcfg)


def test_band_grams_twin_matches_pallas_interpret():
    """Gram twin vs the Pallas kernel (interpret mode), B = 4, logcov8's
    band layout: f32 sums of at most 80 products in different orders,
    atol 2e-4 max|G| (the JAX package's own limit for this kernel)."""
    _, tcfg = _configs("logcov8")
    _, slices = tlc._band_projector(625, tcfg)
    offsets = (0,) + tuple(s.stop for s in slices)
    y = np.random.default_rng(0).standard_normal((4, offsets[-1], 8)).astype(np.float32)
    want = np.asarray(jax_band_grams(jnp.asarray(y), slices, interpret=True))  # [B, nb, 8, 8]
    iu, ju = np.triu_indices(8)
    want = want[:, :, iu, ju].reshape(4, -1)
    got = band_grams(torch.from_numpy(y), offsets).numpy()
    assert got.shape == (4, 8 * 36) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("whitener", ["shipped", "cold5"])
def test_feature_twin_matches_fused_kernel_interpret(filtered, whitener):
    """The kernel route on the CPU (gram twin, then feature twin) vs the
    JAX fused kernel in interpret mode: features within 5e-5 max(scale,
    1) (the JAX package's kernel-vs-stages limit), window flags equal."""
    jcfg, tcfg = _configs("logcov8", whiten=True, dropout=0.0)
    x, whiteners = _guard_inputs(filtered)
    w = whiteners[whitener]
    want, want_flags = jlc._fused_kernel_feats(jnp.asarray(x), jnp.asarray(w), jcfg, True)
    want, want_flags = np.asarray(want), np.asarray(want_flags)
    got, got_flags = tlc._fused_kernel_feats(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    assert got.shape == want.shape == (4, 288)
    np.testing.assert_array_equal(got_flags.numpy(), want_flags)
    if whitener == "cold5":
        assert want_flags[0] and want_flags[3], "railed and flatline windows flag"
        assert not want_flags.all()
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)  # each window's
    assert (np.abs(got.numpy() - want) / scale).max() <= 5e-5


@pytest.mark.parametrize("fused", ["kernel", "stages"])
def test_unguarded_whitened_features_match_jax(filtered, fused):
    """guard_domain=False (either fusion level) takes the stages path in
    both packages, with no guard: features within 5e-5 of each window's
    max(scale, 1), and the domain flags that with_flags reports equal."""
    jcfg, tcfg = _configs("logcov8", whiten=True, guard_domain=False, fused=fused)
    x, whiteners = _guard_inputs(filtered)
    x, w = x[1:3], whiteners["shipped"]  # in-domain windows: the unguarded log is sound
    want, want_flags = jlc.logcov_features(jnp.asarray(x), jcfg, jnp.asarray(w), with_flags=True)
    got, flags = tlc.logcov_features(torch.from_numpy(x), tcfg, torch.from_numpy(w), with_flags=True)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 288)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(got.numpy() - want) / scale).max() <= 5e-5
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))


def test_feature_twin_equals_stages_path(filtered):
    """On the CPU the kernel route's twins and the stages path
    (fused="stages") compute the same arithmetic: features within 1e-6 of
    their scale, flags equal."""
    _, tcfg = _configs("logcov8", whiten=True)
    x, whiteners = _guard_inputs(filtered)
    xt, w = torch.from_numpy(x), torch.from_numpy(whiteners["cold5"])
    fused, fused_flags = tlc._fused_kernel_feats(xt, w, tcfg)
    stages, stage_flags = tlc.logcov_features(xt, dataclasses.replace(tcfg, fused="stages"), w, with_flags=True)
    assert torch.equal(fused_flags, stage_flags)
    assert (fused - stages).abs().max().item() <= 1e-6 * stages.abs().max().item()


def test_feature_twin_per_band_flags():
    """The feature twin's own contract: pair rows in, [B, nb*36] features
    and [B, nb] flags out; a band whose gram is rank one is flagged."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((3, 40, 8)).astype(np.float32))
    y[1, 20:] = torch.from_numpy(rng.standard_normal(8).astype(np.float32))[None] * 5.0
    y[1, 20:] *= torch.linspace(1.0, 2.0, 20)[:, None]  # band 1 of window 1: rank one
    grams = band_grams(y, (0, 20, 40))
    tr = torch.ones((3, 2)) * 1e-9
    wwt = torch.eye(8)[torch.triu_indices(8, 8)[0], torch.triu_indices(8, 8)[1]].repeat(2, 1)
    coeffs = tlc._rational_log_coeffs(0.002, 8.0, 12)
    feats, flags = logcov_feats(
        grams, tr, wwt, (coeffs[0],) + coeffs[1] + coeffs[2],
        scale=1.0, alpha=0.05, lo=0.002, hi=8.0, guard_g=0.05,
    )
    assert feats.shape == (3, 72) and flags.shape == (3, 2) and flags.dtype == torch.bool
    assert flags.tolist() == [[False, False], [False, True], [False, False]]
    assert torch.isfinite(feats).all()
    with pytest.raises(ValueError):
        logcov_feats(grams[:, :36], tr, wwt, (coeffs[0],) + coeffs[1] + coeffs[2],
                     scale=1.0, alpha=0.05, lo=0.002, hi=8.0, guard_g=0.05)
    with pytest.raises(TypeError):
        band_grams(y.double(), (0, 20, 40))
    with pytest.raises(ValueError):
        band_grams(y, (0, 20, 41))


@pytest.mark.parametrize(
    "checkpoint, family, kw",
    [
        ("logcov8wd_ens_s0", "logcov8", {"whiten": True, "dropout": 0.0}),
        ("logcov8_ens_s0", "logcov8", {}),
        ("logcov8_5_wd_ens_s0", "logcov8_5", {"whiten": True, "dropout": 0.0}),
    ],
)
def test_logcov_apply_ex_matches_jax(filtered, checkpoint, family, kw):
    """64 golden windows through features, guard and head: <= 1e-4 max
    |delta logit|, equal argmax and equal guard flags (whitened, unwhitened
    and the 5-class checkpoint)."""
    jcfg, tcfg = _configs(family, **kw)
    jparams = jax_load_npz(CKPT / f"{checkpoint}.npz")
    want, want_aux = jlc.logcov_apply_ex(jparams, jnp.asarray(filtered), jcfg)
    want = np.asarray(want)
    params = params_from_jax(load_params_npz(CKPT / f"{checkpoint}.npz"))
    got, aux = tlc.logcov_apply_ex(params, torch.from_numpy(filtered), tcfg)
    assert got.shape == (64, tcfg.num_classes) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))
    np.testing.assert_array_equal(aux["domain_flags"].numpy(), np.asarray(want_aux["domain_flags"]))


@pytest.mark.parametrize("family", ["logcov", "logcov12"])
def test_unwhitened_features_other_band_layouts(filtered, family):
    """The broad 4-band and the 12-band layouts (R = 450 and 900), no
    whitener: features within 5e-5 of their scale, no flags."""
    jcfg, tcfg = _configs(family)
    x = filtered[:8]
    want, want_flags = jlc.logcov_features(jnp.asarray(x), jcfg, with_flags=True)
    got, flags = tlc.logcov_features(torch.from_numpy(x), tcfg, with_flags=True)
    want = np.asarray(want)
    assert got.shape == want.shape == (8, tlc._num_features(tcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * np.abs(want).max())
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))


def test_unported_backends_raise(filtered):
    """No logcov backend is left unported: an unknown logm or spectral
    method raises ValueError, as in JAX, with or without a whitener and on
    either fusion level; the shrinkage floor is still enforced."""
    x = torch.from_numpy(filtered[:2])
    w = torch.from_numpy(jax_load_npz(CKPT / "logcov8wd_ens_s0.npz")["whitener"])
    for whitener in (None, w):
        for kw in ({"logm": "pade"}, {"logm": "pade", "fused": "stages"}):
            with pytest.raises(ValueError, match="unknown logm backend"):
                tlc.logcov_features(x, tlc.LogCovConfig(bands=_configs("logcov8")[1].bands, **kw), whitener)
            with pytest.raises(ValueError, match="unknown logm backend"):
                jlc.logcov_features(jnp.asarray(filtered[:2]), jlc.LogCovConfig(**kw))
        with pytest.raises(ValueError, match="unknown spectral method"):
            tlc.logcov_features(x, tlc.LogCovConfig(bands=_configs("logcov8")[1].bands, spectral="dct"), whitener)
    with pytest.raises(ValueError, match="unknown spectral method"):
        jlc.logcov_features(jnp.asarray(filtered[:2]), jlc.LogCovConfig(spectral="dct"))
    with pytest.raises(ValueError, match="below the Chebyshev"):
        tlc.LogCovConfig(shrinkage=0.001)


def test_registry_matches_jax():
    """Every family of the JAX registry, with the same class names and an
    equal config (the LSTM's config keeps only the fields the port reads:
    each of those equals JAX's)."""
    assert treg.available_models() == jreg.available_models()
    for name in treg.available_models():
        jspec, tspec = jreg.get_model(name), treg.get_model(name)
        assert tspec.class_names == jspec.class_names
        ours, theirs = dataclasses.asdict(tspec.config), dataclasses.asdict(jspec.config)
        if name.startswith("lstm"):
            theirs = {k: theirs[k] for k in ours}
        assert ours == theirs
    assert treg.get_model("logcov8", bands=[[3, 6], [6, 9]]).config.bands == ((3, 6), (6, 9))
    with pytest.raises(KeyError):
        treg.get_model("nope")
    pairs = ["whiten=true", "shrinkage=0.1", "logcov8_5:dropout=0", "name=abc"]
    assert treg.parse_model_kw(pairs) == jreg.parse_model_kw(pairs)
    kw = treg.parse_model_kw(pairs)
    for fam in ("logcov8", "logcov8_5"):
        assert treg.family_model_kw(kw, fam) == jreg.family_model_kw(kw, fam)
