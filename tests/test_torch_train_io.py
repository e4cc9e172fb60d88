"""The training path's writers and CLI against the JAX package, on the CPU:
the port's .npz and .pth are read by JAX's loaders (equal arrays; JAX's
apply gives the port's logits within 1e-4), the train-state checkpoints
round-trip, and `python -m neural_speech_decoding_tpu_torch.train` trains
with --device cpu, writes a checkpoint that both packages serve, and
refuses --mesh.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.io.checkpoint import load_decoder_params as jax_load_pth_params
from neural_speech_decoding_tpu.io.checkpoint import load_torch_checkpoint as jax_load_pth
from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state as jax_to_state
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.logcov import LogCovConfig as JaxLogCovConfig
from neural_speech_decoding_tpu.models.logcov import logcov_apply as jax_logcov_apply
from neural_speech_decoding_tpu.models.lstm import decoder_apply as jax_decoder_apply
from neural_speech_decoding_tpu_torch.config import DecoderConfig, FilterConfig
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.checkpoint import load_decoder_params
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz, save_params_npz
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits, init_decoder_params
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.train import checkpointing
from neural_speech_decoding_tpu_torch.train.__main__ import main
from neural_speech_decoding_tpu_torch.train.loop import _leaves

T, C = 625, 8
NARROW = ((3.0, 6.0), (6.0, 9.0), (9.0, 13.0), (13.0, 18.0), (18.0, 24.0), (24.0, 32.0), (32.0, 40.0), (40.0, 48.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trials_dir(tmp_path_factory):
    """18 trials of 625 x 8 in the collector's CSV layout, 6 a class, each
    class with its own tone under noise."""
    d = tmp_path_factory.mktemp("trials")
    rng = np.random.default_rng(0)
    tt = np.arange(T) / 125.0
    for c, name in enumerate(("food", "water", "backgroundnoise")):
        for i in range(6):
            tone = np.sin(2 * np.pi * (6 + 8 * c) * tt + rng.uniform(0, 6.3))
            x = 20.0 * tone[:, None] * (1 + 0.2 * np.arange(C)) + 10.0 * rng.standard_normal((T, C))
            np.savetxt(d / f"{name}_{i:04d}.csv", x, delimiter=",", fmt="%.7f")
    return d


def _tiny_lstm(seed=0, layers=2):
    cfg = DecoderConfig(hidden_size=8, num_layers=layers)
    return init_decoder_params(torch.Generator().manual_seed(seed), cfg)


def test_npz_writer_read_by_jax(tmp_path):
    params = _tiny_lstm(layers=3)
    path = tmp_path / "sub" / "m.npz"
    save_params_npz(path, params)
    theirs, ours = jax_load_npz(path), load_params_npz(path)
    for tree in (theirs, ours):
        got = dict(_leaves(tree))
        for key, t in _leaves(params):
            np.testing.assert_array_equal(np.asarray(got[key]), t.numpy())
    assert np.asarray(theirs["attn"]["b"]).shape == ()
    x = np.random.default_rng(1).standard_normal((4, 64, C)).astype(np.float32)
    want = np.asarray(jax_decoder_apply(theirs, jnp.asarray(x), JaxDecoderConfig()))
    got = decoder_logits(params, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    with pytest.raises(ValueError, match="may not contain"):
        save_params_npz(tmp_path / "bad.npz", {"a.b": np.zeros(2)})


def test_pth_writer_read_by_jax(tmp_path):
    params = _tiny_lstm(seed=3)
    state = decoder_params_to_torch_state(params)
    want_state = jax_to_state({k: params[k] for k in params})  # tensor leaves read as arrays
    assert list(state) == list(want_state)
    for k in state:
        np.testing.assert_array_equal(state[k], want_state[k])
    path = tmp_path / "m.pth"
    save_torch_checkpoint(path, state)
    loaded = jax_load_pth(path)
    assert list(loaded) == list(state)
    for k in state:
        np.testing.assert_array_equal(loaded[k], state[k])
    # both packages' .pth loaders give back the pytree, and the logits agree
    theirs = jax_load_pth_params(path)
    ours = load_decoder_params(path)
    for key, t in _leaves(params):
        np.testing.assert_array_equal(np.asarray(dict(_leaves(theirs))[key]), t.numpy())
        np.testing.assert_array_equal(np.asarray(dict(_leaves(ours))[key]), t.numpy())
    with pytest.raises(ValueError, match="unsupported dtype"):
        save_torch_checkpoint(tmp_path / "bad.pth", {"x": np.zeros(2, np.float16)})


def test_train_state_checkpoints(tmp_path):
    params = _tiny_lstm()
    for path, t in _leaves(params):
        t.requires_grad_(True)
    for epoch in range(5):
        checkpointing.save_train_state(tmp_path, epoch, params, {"count": epoch})
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"epoch_{e:08d}.pt" for e in (2, 3, 4)]
    assert checkpointing.latest_epoch(tmp_path) == 4
    assert checkpointing.latest_epoch(tmp_path / "none") is None
    epoch, restored, opt_state = checkpointing.restore_train_state(tmp_path, params)
    assert epoch == 4 and opt_state == {"count": 4}
    for (key, a), (_, b) in zip(_leaves(restored), _leaves(params)):
        assert torch.equal(a, b.detach()) and not a.requires_grad, key
    with pytest.raises(FileNotFoundError):
        checkpointing.restore_train_state(tmp_path / "none", params)


def test_cli_trains_an_lstm_on_the_cpu(trials_dir, tmp_path):
    out, hist = tmp_path / "lstm.npz", tmp_path / "hist.json"
    main([
        "--model", "lstm", "--model-kw", "hidden_size=8", "--data-dir", str(trials_dir), "--device", "cpu",
        "--epochs", "2", "--batch-size", "8", "--lr", "3e-3", "--out", str(out), "--history-out", str(hist),
    ])
    history = json.loads(hist.read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    theirs = jax_load_npz(out)
    assert np.asarray(theirs["lstm"][0]["w_hh"]).shape == (8, 32)
    windows = load_trials(trials_dir).windows[:6]
    filtered = mai_filter_batch(windows, FilterConfig(precision="fast"), device="cpu")
    want = np.asarray(jax_decoder_apply(theirs, jnp.asarray(filtered.numpy()), JaxDecoderConfig()))
    got = decoder_logits(params_from_jax(load_params_npz(out)), filtered).numpy()
    assert np.abs(got - want).max() <= 1e-4
    engine = InferenceEngine(str(out), device="cpu")
    probs = engine.predict_batch(windows)
    assert probs.shape == (6, 3) and np.allclose(probs.sum(1), 1.0, atol=1e-5)


def test_cli_trains_the_flagship_recipe_on_the_cpu(trials_dir, tmp_path):
    out = tmp_path / "logcov.npz"
    main([
        "--model", "logcov8", "--model-kw", "whiten=true", "--model-kw", "dropout=0.0", "--augment", "0.5",
        "--label-smoothing", "0.1", "--data-dir", str(trials_dir), "--device", "cpu", "--epochs", "5",
        "--batch-size", "8", "--out", str(out),
    ])
    theirs = jax_load_npz(out)
    assert np.asarray(theirs["whitener"]).shape == (8, 8, 8)
    windows = load_trials(trials_dir).windows[:6]
    filtered = mai_filter_batch(windows, FilterConfig(precision="fast"), device="cpu")
    want = np.asarray(jax_logcov_apply(theirs, jnp.asarray(filtered.numpy()), JaxLogCovConfig(bands=NARROW, whiten=True)))
    spec = get_model("logcov8", whiten=True, dropout=0.0)
    got = spec.apply(params_from_jax(load_params_npz(out)), filtered).numpy()
    assert np.abs(got - want).max() <= 1e-4
    engine = InferenceEngine(str(out), model="logcov8", model_kw={"whiten": True, "dropout": 0.0}, device="cpu")
    np.testing.assert_allclose(engine.logits_batch(windows), got, rtol=0, atol=1e-5)


def test_cli_refusals(trials_dir, tmp_path, capsys, monkeypatch):
    # --mesh trains over make_mesh(tp=1) and prints it, as the JAX CLI does
    # (here a mesh of two CPU places stands in for the visible cards)
    import neural_speech_decoding_tpu_torch.train.__main__ as cli

    real_make_mesh = cli.make_mesh
    monkeypatch.setattr(cli, "make_mesh", lambda tp=None: real_make_mesh(["cpu"] * 2, tp=tp))
    out = tmp_path / "mesh.npz"
    main(["--mesh", "--device", "cpu", "--data-dir", str(trials_dir), "--model", "logcov8",
          "--model-kw", "whiten=true", "--model-kw", "dropout=0.0", "--epochs", "1", "--batch-size", "8",
          "--out", str(out)])
    assert "mesh: {'dp': 2, 'tp': 1}" in capsys.readouterr().out
    assert np.asarray(jax_load_npz(out)["whitener"]).shape == (8, 8, 8)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--mesh", "--data-dir", str(trials_dir)])
    monkeypatch.undo()
    with pytest.raises(SystemExit):
        main(["--model", "nope"])
