"""Port parity of the training path's models: train mode, gradients, init,
the per-layer LSTM, turbo, dropout, the whitener fit and the kernel
routes' backward, each against the JAX package on the CPU.

Inputs are seeded numpy arrays; parameters are JAX's own init, carried
across with io/from_jax.py. Train mode is made deterministic with dropout 0
and rrelu_lower == rrelu_upper (the two frameworks draw different bits from
their generators). Tolerances:
  train-mode logits            <= 1e-4 max |delta|
  gradients, per leaf          <= 1e-4 * max(1, max |g|)
  fit_whitener                 <= 1e-5 * max(1, max |W|)
  kernel-route backward        <= 1e-4 of the largest JAX cotangent
  turbo (bfloat16) logits      equal argmax; |delta| against JAX's own
                               bfloat16 no larger than JAX's documented
                               turbo-vs-f32 figure, 2.6e-1 (config.py:71-76)
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models import logcov as jax_logcov
from neural_speech_decoding_tpu.models.lstm import decoder_apply as jax_decoder_apply
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.ops.pallas.bandcov import _band_grams_xla
from neural_speech_decoding_tpu.ops.pallas.logm import _logm_clenshaw_xla
from neural_speech_decoding_tpu.train.loop import _loss_fn as jax_loss_fn
from neural_speech_decoding_tpu_torch.config import DecoderConfig
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models import logcov
from neural_speech_decoding_tpu_torch.models.lstm import decoder_apply, decoder_logits
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.models.stochastic import dropout, uniform_like
from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams
from neural_speech_decoding_tpu_torch.ops.kernels.logm import logm_spd_chebyshev
from neural_speech_decoding_tpu_torch.train.loop import _leaves, _loss_fn

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"
NARROW = ((3.0, 6.0), (6.0, 9.0), (9.0, 13.0), (13.0, 18.0), (18.0, 24.0), (24.0, 32.0), (32.0, 40.0), (40.0, 48.0))
T, C, B = 64, 8, 6
SMOOTHING = 0.1
CLASS_WEIGHTS = (1.0, 2.0, 0.5)
DETERMINISTIC_LSTM = dict(hidden_size=8, dropout=0.0, rrelu_lower=0.2, rrelu_upper=0.2)

# (registry name, config overrides): narrow widths, deterministic train mode
CASES = {
    "lstm_depth1": ("lstm", dict(num_layers=1, **DETERMINISTIC_LSTM)),
    "lstm_depth2": ("lstm", dict(num_layers=2, **DETERMINISTIC_LSTM)),
    "lstm_depth3": ("lstm", dict(num_layers=3, **DETERMINISTIC_LSTM)),
    "eegnet": ("eegnet", dict(
        window_samples=T, temporal_filters=4, depth_multiplier=2, separable_filters=8,
        temporal_kernel=16, separable_kernel=8, pool1=4, pool2=4, dropout=0.0,
    )),
    "tcn": ("tcn", dict(width=16, blocks=3, kernel=3, dropout=0.0)),
    "transformer": ("transformer", dict(
        window_samples=T, patch=8, embed=16, heads=2, layers=2, ffn=32, dropout=0.0,
    )),
    "lru": ("lru", dict(hidden=16, readout=12, mlp_hidden=8, dropout=0.0)),
    "logcov8_whitened": ("logcov8", dict(whiten=True, dropout=0.0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed: int = 0, b: int = B, t: int = T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, C)).astype(np.float32)
    x += np.sin(np.arange(t) * 0.4)[None, :, None].astype(np.float32)
    y = (np.arange(b) % 3).astype(np.int32)
    return x, y


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _jax_case(case: str):
    """JAX's init (and fit), train-mode logits and loss gradients."""
    name, kw = CASES[case]
    spec = jax_get_model(name, **kw)
    x, y = _data()
    params = spec.init(jax.random.PRNGKey(7))
    if spec.fit is not None:
        params = spec.fit(params, jnp.asarray(x), jnp.asarray(y))
    rng = jax.random.PRNGKey(3)

    @jax.jit
    def logits_and_grads(p, xx, yy):
        def loss(q):
            return jax_loss_fn(q, xx, yy, rng, spec.apply, SMOOTHING, CLASS_WEIGHTS)[0]

        return spec.apply(p, xx, train=True, rng=rng), jax.grad(loss)(p)

    logits, grads = logits_and_grads(params, jnp.asarray(x), jnp.asarray(y))
    return _np_tree(params), np.asarray(logits), _np_tree(grads)


def _port_params(jax_params):
    params = params_from_jax(jax_params)
    for path, t in _leaves(params):
        t.requires_grad_("whitener" not in path)
    return params


@pytest.mark.parametrize("case", list(CASES))
def test_train_mode_logits_match_jax(case):
    jparams, want, _ = _jax_case(case)
    name, kw = CASES[case]
    x, _ = _data()
    gen = torch.Generator().manual_seed(0)
    got = get_model(name, **kw).apply(params_from_jax(jparams), torch.from_numpy(x), train=True, generator=gen)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradients_match_jax(case):
    """d(label-smoothed, class-weighted loss)/d(every parameter leaf)."""
    jparams, _, jgrads = _jax_case(case)
    name, kw = CASES[case]
    x, y = _data()
    params = _port_params(jparams)
    gen = torch.Generator().manual_seed(0)
    loss, _ = _loss_fn(
        params, torch.from_numpy(x), torch.from_numpy(y), gen, get_model(name, **kw).apply,
        SMOOTHING, CLASS_WEIGHTS,
    )
    paths, leaves = zip(*[(p, t) for p, t in _leaves(params) if t.requires_grad])
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    for path, want in _leaves(jgrads):
        got = grads[path].numpy() if path in grads else np.zeros_like(want)  # the whitener: zero
        assert got.shape == want.shape, path
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, (path, np.abs(got - want).max(), tol)


@pytest.mark.parametrize("name, kw", [
    ("lstm", {}), ("lstm5", {"num_layers": 3}), ("eegnet", {}), ("tcn", {}), ("transformer", {}),
    ("lru", {}), ("logcov8", {"whiten": True}), ("logcov", {}),
])
def test_init_matches_jax_structure(name, kw):
    """Same pytree keys, shapes and dtypes as JAX's init, at full width."""
    want = jax_get_model(name, **kw).init(jax.random.PRNGKey(0))
    got = get_model(name, **kw).init(torch.Generator().manual_seed(0))
    want_leaves = {path: np.asarray(w) for path, w in _leaves(want)}
    got_leaves = dict(_leaves(got))
    assert sorted(got_leaves, key=str) == sorted(want_leaves, key=str)
    for path, g in got_leaves.items():
        assert tuple(g.shape) == want_leaves[path].shape, path
        assert g.dtype == torch.float32 and want_leaves[path].dtype == np.float32, path
        assert torch.isfinite(g).all(), path


def test_init_distributions():
    """The LSTM's torch-default bounds and the constant leaves."""
    h = 48
    p = get_model("lstm").init(torch.Generator().manual_seed(1))
    bound = 1.0 / np.sqrt(h)
    w = p["lstm"][0]["w_hh"]
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert p["lstm"][0]["b"].abs().max() <= 2 * bound
    assert torch.equal(p["ln"]["scale"], torch.ones(h)) and torch.equal(p["ln"]["bias"], torch.zeros(h))
    q = get_model("logcov8", whiten=True).init(torch.Generator().manual_seed(1))
    assert torch.equal(q["whitener"], torch.eye(8).expand(8, 8, 8))
    assert abs(float(q["head"]["w"].std()) - np.sqrt(1 / 288)) < 0.2 * np.sqrt(1 / 288)


def test_remat_chunks_changes_no_gradient():
    """remat_chunks recomputes each chunk's steps in backward: the same
    loss and gradients (JAX tests/test_train.py:119)."""
    jparams, _, _ = _jax_case("lstm_depth2")
    x, y = _data()
    out = []
    for chunks in (0, 4, 16):
        params = _port_params(jparams)
        cfg = DecoderConfig(num_layers=2, remat_chunks=chunks, **DETERMINISTIC_LSTM)
        loss, _ = _loss_fn(
            params, torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(0),
            lambda p, xx, *, train, generator: decoder_apply(p, xx, cfg, train=train, generator=generator),
            SMOOTHING, None,
        )
        leaves = [t for _, t in _leaves(params)]
        out.append((float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, leaves)]))
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        for g, g0 in zip(grads, out[0][1]):
            np.testing.assert_allclose(g, g0, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="does not divide"):
        decoder_apply(_port_params(jparams), torch.from_numpy(x), DecoderConfig(remat_chunks=5, **DETERMINISTIC_LSTM),
                      train=True, generator=torch.Generator())


def test_eval_per_layer_matches_streaming():
    """Eval mode with the streaming scan switched off runs the per-layer
    recurrence: the same logits as JAX's (and as the streaming loop) on
    the shipped checkpoint."""
    with np.load(GOLDEN, allow_pickle=False) as z:
        x = z["filtered"][:8]
    jp = jax_load_npz(REPO / "checkpoints" / "lstm3_retrained.npz")
    want = np.asarray(jax_decoder_apply(jp, jnp.asarray(x), JaxDecoderConfig(streaming_scan=False)))
    p = params_from_jax(jp)
    per_layer = decoder_logits(p, torch.from_numpy(x), DecoderConfig(streaming_scan=False)).numpy()
    streaming = decoder_logits(p, torch.from_numpy(x)).numpy()
    assert np.abs(per_layer - want).max() <= 1e-4
    assert np.abs(per_layer - streaming).max() <= 1e-4
    builtin = decoder_logits(p, torch.from_numpy(x), DecoderConfig(gate_math="builtin")).numpy()
    want_b = np.asarray(jax_decoder_apply(jp, jnp.asarray(x), JaxDecoderConfig(gate_math="builtin")))
    assert np.abs(builtin - want_b).max() <= 1e-4


def test_turbo_matches_jax_bfloat16():
    """bfloat16 recurrence on 32 golden windows: the port's per-layer turbo
    against JAX's streaming turbo."""
    with np.load(GOLDEN, allow_pickle=False) as z:
        filtered = z["filtered"]
    x = filtered[np.linspace(0, len(filtered) - 1, 32).astype(int)]
    jp = jax_load_npz(REPO / "checkpoints" / "lstm3_retrained.npz")
    want = np.asarray(jax_decoder_apply(jp, jnp.asarray(x), JaxDecoderConfig(recurrence_dtype="bfloat16")))
    want_f32 = np.asarray(jax_decoder_apply(jp, jnp.asarray(x), JaxDecoderConfig()))
    got = decoder_logits(params_from_jax(jp), torch.from_numpy(x), DecoderConfig(recurrence_dtype="bfloat16")).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(want.argmax(1), want_f32.argmax(1))
    assert np.abs(got - want).max() <= 2.6e-1


def test_dropout_and_rrelu_draws():
    """Kept share 1 - rate within 5 sigma, kept values x / keep exactly,
    the same seed the same mask, another seed another; RReLU slopes in
    [lower, upper] with mean (lower + upper) / 2, and exactly lower when
    the bounds are equal."""
    n, rate = 200_000, 0.3
    x = torch.full((n,), 2.0)
    a = dropout(x, rate, torch.Generator().manual_seed(5))
    kept = a != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(a[kept], torch.full((int(kept.sum()),), 2.0 / (1 - rate)))
    assert torch.equal(a, dropout(x, rate, torch.Generator().manual_seed(5)))
    assert not torch.equal(a, dropout(x, rate, torch.Generator().manual_seed(6)))
    assert dropout(x, 0.0, torch.Generator()) is x
    s = uniform_like(x, 1 / 8, 1 / 3, torch.Generator().manual_seed(2))
    assert float(s.min()) >= 1 / 8 and float(s.max()) <= 1 / 3
    assert abs(float(s.mean()) - (1 / 8 + 1 / 3) / 2) < 1e-3
    assert torch.equal(uniform_like(x, 0.2, 0.2, torch.Generator()), torch.full((n,), 0.2))
    # train mode with dropout on is random, eval mode is not
    spec = get_model("lstm", hidden_size=8)
    p = spec.init(torch.Generator().manual_seed(0))
    xb = torch.from_numpy(_data()[0])
    t1 = spec.apply(p, xb, train=True, generator=torch.Generator().manual_seed(1))
    t2 = spec.apply(p, xb, train=True, generator=torch.Generator().manual_seed(1))
    t3 = spec.apply(p, xb, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    with pytest.raises(ValueError, match="requires a generator"):
        spec.apply(p, xb, train=True)


def test_fit_whitener_matches_jax():
    with np.load(GOLDEN, allow_pickle=False) as z:
        x = z["filtered"][::6]
    cfg_kw = dict(bands=NARROW, whiten=True)
    jcfg, cfg = jax_logcov.LogCovConfig(**cfg_kw), logcov.LogCovConfig(**cfg_kw)
    want = np.asarray(jax_logcov.fit_whitener({}, jnp.asarray(x), cfg=jcfg)["whitener"])
    params = logcov.init_logcov_params(torch.Generator().manual_seed(0), cfg)
    got = logcov.fit_whitener(params, x, cfg=cfg)["whitener"].numpy()
    assert got.shape == want.shape == (8, 8, 8) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(np.abs(want).max()))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_band_grams_backward_matches_jax():
    cfg = logcov.LogCovConfig(bands=NARROW)
    _, slices = logcov._band_projector(T, cfg)
    offsets = logcov._band_offsets(slices)
    rng = np.random.default_rng(11)
    y = rng.standard_normal((5, offsets[-1], C)).astype(np.float32)
    ct = rng.standard_normal((5, len(slices) * 36)).astype(np.float32)
    yt = torch.from_numpy(y).requires_grad_(True)
    band_grams(yt, offsets).backward(torch.from_numpy(ct))
    iu, ju = np.triu_indices(C)
    ct_full = np.zeros((5, len(slices), C, C), np.float32)
    ct_full[:, :, iu, ju] = ct.reshape(5, len(slices), 36)
    sl = tuple((s.start, s.stop) for s in slices)
    _, vjp = jax.vjp(lambda v: _band_grams_xla(v, sl), jnp.asarray(y))
    (want,) = vjp(jnp.asarray(ct_full))
    assert _rel(yt.grad.numpy(), np.asarray(want)) <= 1e-4


def test_logm_clenshaw_backward_matches_jax():
    cfg = logcov.LogCovConfig(logm="chebyshev")
    x, _ = _data(seed=12, b=4)
    s = logcov.band_covariances(torch.from_numpy(x), cfg)  # in-domain SPD [4, 4, 8, 8]
    coeffs = logcov._cheb_log_coeffs(*cfg.cheb_interval, cfg.cheb_degree)
    ct = np.random.default_rng(13).standard_normal(tuple(s.shape)).astype(np.float32)
    st = s.detach().clone().requires_grad_(True)
    logm_spd_chebyshev(st, coeffs, *cfg.cheb_interval).backward(torch.from_numpy(ct))
    want = jax.jit(lambda m, c: jax.vjp(lambda u: _logm_clenshaw_xla(u, coeffs, *cfg.cheb_interval), m)[1](c)[0])(
        jnp.asarray(s.detach().numpy()), jnp.asarray(ct)
    )
    assert _rel(st.grad.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("logm", ["rational", "chebyshev"])
def test_kernel_route_backward_matches_jax(logm):
    """The logcov kernel route (its twins on the CPU) differentiated in the
    windows: the autograd Function's backward against jax.vjp of JAX's
    _stages_feats_reference; the whitener gets a zero gradient."""
    kw = dict(bands=NARROW, whiten=True, logm=logm)
    jcfg, cfg = jax_logcov.LogCovConfig(**kw), logcov.LogCovConfig(**kw)
    x, _ = _data(seed=14, b=4)
    w0 = np.array(jax_logcov.fit_whitener({}, jnp.asarray(_data(seed=15, b=16)[0]), cfg=jcfg)["whitener"])
    ct = np.random.default_rng(16).standard_normal((4, 8 * 36)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w0).requires_grad_(True)
    feats, flags = logcov._fused_kernel_feats(xt, wt, cfg)
    assert not flags.requires_grad
    feats.backward(torch.from_numpy(ct))
    want = jax.jit(lambda v, c: jax.vjp(lambda u: jax_logcov._stages_feats_reference(u, jnp.asarray(w0), jcfg), v)[1](c)[0])(
        jnp.asarray(x), jnp.asarray(ct)
    )
    assert _rel(xt.grad.numpy(), np.asarray(want)) <= 1e-4
    assert torch.equal(wt.grad, torch.zeros_like(wt))
    # the public surface routes there and detaches the whitener
    x2 = torch.from_numpy(x).requires_grad_(True)
    logcov.logcov_features(x2, cfg, whitener=wt).backward(torch.from_numpy(ct))
    assert torch.allclose(x2.grad, xt.grad)
