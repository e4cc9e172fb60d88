"""Port parity of the training loop: the optimizer against optax, the data
split and augmentation against the JAX package, and the loop end to end
on the CPU (falling loss, head-space against full-apply training,
keep_best, early stop, resume, refusals).

Tolerances: parameters after 3 optimizer steps <= 1e-6; the learning-rate
schedule equal to optax's float32 value at every step; split and augment
exactly equal.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from neural_speech_decoding_tpu.io.dataset import load_trials as jax_load_trials
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.train import augment as jax_augment
from neural_speech_decoding_tpu.train.loop import TrainConfig as JaxTrainConfig
from neural_speech_decoding_tpu.train.loop import _optimizer as jax_optimizer
from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, DecoderConfig
from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset, load_trials
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.train import augment, checkpointing
from neural_speech_decoding_tpu_torch.train.loop import (
    Optimizer,
    TrainConfig,
    _leaves,
    _schedule,
    make_eval_fn,
    train,
)

C = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
OPT_CASES = {
    "adam": dict(learning_rate=1e-2, grad_clip=0.0),
    "adamw_whitener": dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=0.0),
    "clipping": dict(learning_rate=1e-2, grad_clip=1.0),
    "cosine": dict(learning_rate=1e-2, schedule="cosine", epochs=3, warmup_epochs=1, weight_decay=0.05),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """The same JAX gradients through optax and through the port's
    optimizer for 3 steps (the whitener's gradient zero, as JAX's
    stop_gradient makes it)."""
    kw = OPT_CASES[case]
    params = jax_get_model("logcov8", whiten=True).init(jax.random.PRNGKey(0))
    params["whitener"] = params["whitener"] * 1.5  # a fitted buffer that decay must not touch
    rng = np.random.default_rng(3)
    grads = []
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.7, params)
        g["whitener"] = np.zeros_like(g["whitener"])
        grads.append(g)
    tx = jax_optimizer(JaxTrainConfig(**kw), steps_per_epoch=1)
    state = tx.init(params)
    want = params
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)

    port = params_from_jax(params)
    for path, t in _leaves(port):
        t.requires_grad_("whitener" not in path)
    opt = Optimizer(port, TrainConfig(**kw), steps_per_epoch=1)
    for g in grads:
        by_path = dict(_leaves(g))
        for path, t in _leaves(port):
            t.grad = torch.from_numpy(by_path[path].copy()) if t.requires_grad else None
        opt.step()
    want_leaves = dict(_leaves(want))
    for path, got in _leaves(port):
        w = np.asarray(want_leaves[path])
        assert np.abs(got.detach().numpy() - w).max() <= 1e-6, path
    np.testing.assert_array_equal(port["whitener"].numpy(), np.asarray(params["whitener"]))


@pytest.mark.parametrize("epochs, warmup, steps", [(3, 1, 1), (60, 5, 4), (10, 0, 7)])
def test_schedule_matches_optax(epochs, warmup, steps):
    cfg = TrainConfig(learning_rate=3e-3, schedule="cosine", epochs=epochs, warmup_epochs=warmup)
    w = max(1, warmup * steps)
    total = max(w + 1, epochs * steps)
    want = optax.warmup_cosine_decay_schedule(3e-5, 3e-3, w, total, 3e-5)
    got = _schedule(cfg, steps)
    for count in range(total + 3):
        assert np.float32(got(count)) == np.float32(want(count)), count
    assert _schedule(TrainConfig(learning_rate=0.5), steps)(7) == 0.5
    with pytest.raises(ValueError, match="unknown schedule"):
        _schedule(TrainConfig(schedule="nope"), 1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _write_trials(directory, counts, t=625, seed=0):
    rng = np.random.default_rng(seed)
    for cls, n in counts.items():
        for i in range(n):
            x = rng.standard_normal((t, C)) * 20.0
            np.savetxt(directory / f"{cls}_{i:04d}-{seed}.csv", x, delimiter=",", fmt="%.7f")


def test_split_and_augment_match_jax(tmp_path):
    _write_trials(tmp_path, {"food": 7, "water": 5, "backgroundnoise": 4, "yes": 3, "no": 2})
    (tmp_path / "notes_0.csv").write_text("1,2\n")  # no class prefix: skipped
    for prefixes in ((), FIVE_CLASS_PREFIXES):
        kw = {"class_prefixes": prefixes} if prefixes else {}
        ours, theirs = load_trials(tmp_path, **kw), jax_load_trials(tmp_path, **kw)
        assert ours.files == theirs.files and ours.class_prefixes == theirs.class_prefixes
        np.testing.assert_array_equal(ours.windows, theirs.windows)
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        for frac, seed in ((0.2, 0), (0.3, 5)):
            (a_tr, a_va), (b_tr, b_va) = ours.split(frac, seed), theirs.split(frac, seed)
            assert a_tr.files == b_tr.files and a_va.files == b_va.files
            np.testing.assert_array_equal(a_tr.windows, b_tr.windows)
        for kinds in (augment.KINDS, augment.ALL_KINDS):
            a = augment.augment_batch_np(ours.windows, ours.labels, prob=0.7, seed=3, kinds=kinds)
            b = jax_augment.augment_batch_np(theirs.windows, theirs.labels, prob=0.7, seed=3, kinds=kinds)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    rng = np.random.default_rng(1)
    w = ours.windows[0]
    for kind in augment.ALL_KINDS:
        np.testing.assert_array_equal(
            augment.inject_noise_np(w, kind, np.random.default_rng(9)),
            jax_augment.inject_noise_np(w, kind, np.random.default_rng(9)),
        )
    with pytest.raises(ValueError, match="unknown noise kind"):
        augment.inject_noise_np(w, "nope", rng)
    with pytest.raises(FileNotFoundError):
        load_trials(tmp_path / "missing")


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _separable(n_per_class=10, t=64, seed=0) -> TrialDataset:
    """Class c carries a tone of frequency 4 + 5c cycles a window on every
    channel, under noise."""
    rng = np.random.default_rng(seed)
    xs, ys, files = [], [], []
    tt = np.arange(t) / t
    for c, name in enumerate(("food", "water", "backgroundnoise")):
        for i in range(n_per_class):
            tone = np.sin(2 * np.pi * (4 + 5 * c) * tt + rng.uniform(0, 2 * np.pi))
            xs.append((tone[:, None] * (1 + 0.1 * np.arange(C)) + 0.3 * rng.standard_normal((t, C))).astype(np.float32))
            ys.append(c)
            files.append(f"{name}_{i:04d}.csv")
    return TrialDataset(np.stack(xs), np.asarray(ys, np.int32), ("food", "water", "backgroundnoise"), tuple(files))


def test_train_lowers_the_loss():
    ds = _separable()
    _, hist = train(
        ds, decoder_cfg=DecoderConfig(hidden_size=8, dropout=0.1),
        train_cfg=TrainConfig(epochs=6, batch_size=8, learning_rate=1e-2, keep_best=False),
        preprocessed=ds.windows, verbose=False, device="cpu",
    )
    assert [h["epoch"] for h in hist] == list(range(6))
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    params, hist = train(
        ds, model="eegnet", model_kw=dict(window_samples=64, temporal_kernel=16, pool2=4),
        train_cfg=TrainConfig(epochs=8, batch_size=8, learning_rate=3e-3, augment_prob=0.5, schedule="cosine"),
        preprocessed=ds.windows, verbose=False, device="cpu",
    )
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert all(not t.requires_grad and t.device.type == "cpu" for _, t in _leaves(params))


LOGCOV_KW = dict(whiten=True, dropout=0.0)


def test_featurize_and_full_apply_give_the_same_history():
    """With dropout 0 the head-space fast path (featurize once) and the
    full apply (features every step, through the kernel route's twins)
    are the same training."""
    ds = _separable(t=125)
    spec = get_model("logcov8", **LOGCOV_KW)
    cfg = TrainConfig(epochs=4, batch_size=8, learning_rate=1e-2, label_smoothing=0.1, augment_prob=0.5)
    p_fast, h_fast = train(ds, model=spec, train_cfg=cfg, preprocessed=ds.windows, verbose=False, device="cpu")
    full = dataclasses.replace(spec, featurize=None)
    p_full, h_full = train(ds, model=full, train_cfg=cfg, preprocessed=ds.windows, verbose=False, device="cpu")
    for a, b in zip(h_fast, h_full):
        for k in ("train_loss", "train_accuracy", "val_loss", "val_accuracy"):
            assert abs(a[k] - b[k]) <= 1e-5, k
    for (path, a), (_, b) in zip(_leaves(p_fast), _leaves(p_full)):
        assert torch.allclose(a, b, rtol=0, atol=1e-5), path


def test_keep_best_early_stop_and_resume(tmp_path):
    ds = _separable(t=125)
    spec = get_model("logcov8", **LOGCOV_KW)
    base = TrainConfig(epochs=6, batch_size=8, learning_rate=1e-2)
    # keep_best: the returned head scores the best epoch's val accuracy
    params, hist = train(ds, model=spec, train_cfg=base, preprocessed=ds.windows, verbose=False, device="cpu")
    _, val = ds.split(base.val_fraction, seed=base.seed)
    acc = make_eval_fn(spec)(params, torch.from_numpy(val.windows), torch.from_numpy(val.labels).long(),
                             torch.ones(len(val)))["accuracy"]
    assert float(acc) == max(h["val_accuracy"] for h in hist)
    # early stop: with a zero learning rate nothing improves after epoch 0
    _, hist = train(ds, model=spec, train_cfg=dataclasses.replace(base, learning_rate=0.0, early_stop_patience=2),
                    preprocessed=ds.windows, verbose=False, device="cpu")
    assert len(hist) == 3
    # resume: a run cut after epoch 2 goes on at epoch 3 from its checkpoint
    ck = dataclasses.replace(base, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1, keep_best=False)
    p3, hist = train(ds, model=spec, train_cfg=dataclasses.replace(ck, epochs=3), preprocessed=ds.windows,
                     verbose=False, device="cpu")
    assert checkpointing.latest_epoch(ck.checkpoint_dir) == 2
    epoch, restored, opt_state = checkpointing.restore_train_state(ck.checkpoint_dir, p3)
    assert epoch == 2 and opt_state["count"] == 9  # 24 training windows: 3 steps an epoch
    for (_, a), (_, b) in zip(_leaves(restored), _leaves(p3)):
        assert torch.equal(a, b)
    _, hist = train(ds, model=spec, train_cfg=ck, preprocessed=ds.windows, verbose=False, device="cpu")
    assert [h["epoch"] for h in hist] == [3, 4, 5]
    assert checkpointing.latest_epoch(ck.checkpoint_dir) == 5
    assert len(list((tmp_path / "ck").glob("epoch_*.pt"))) == 3
    # a finished run resumes to nothing
    _, hist = train(ds, model=spec, train_cfg=ck, preprocessed=ds.windows, verbose=False, device="cpu")
    assert hist == []


def test_train_refusals(monkeypatch):
    ds = _separable(n_per_class=2)
    # a mesh trains (data parallel over the CPU repeated); its primary
    # device is the training device
    from neural_speech_decoding_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cpu"] * 2, tp=1)
    params, hist = train(ds, mesh=mesh, train_cfg=TrainConfig(epochs=1, batch_size=2, val_fraction=0.5),
                         preprocessed=ds.windows, verbose=False, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    with pytest.raises(ValueError, match="primary"):
        train(ds, mesh=mesh, preprocessed=ds.windows, verbose=False, device="meta")
    with pytest.raises(ValueError, match="unknown schedule"):
        train(ds, train_cfg=TrainConfig(epochs=1, schedule="nope"), preprocessed=ds.windows, verbose=False,
              device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        train(ds, preprocessed=ds.windows[:1], verbose=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(ds, preprocessed=ds.windows, verbose=False)
