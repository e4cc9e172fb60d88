"""The port's StreamDecoder on the CPU, held against the JAX package's
engine: a ReplayBoard is deterministic, so the window that ended at board
counter c is the replay source's samples (c-n+1 .. c) mod its length, and
every StreamPrediction is held against the JAX engine's predict_batch on
that rebuilt window (<= 1e-5 |delta prob|, equal labels), its rolling
average against the mean of the last N such results. Timing is never
asserted.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from jax import random as jax_random

from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.io.params_io import save_params_npz as jax_save_npz
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu_torch.runtime.board import ReplayBoard
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder, main

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints"
T, C = 625, 8
PROB_TOL = 1e-5
SMALL_LSTM = {"hidden_size": 8}
CLASSES = ("Food", "Water", "None")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def raw_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8]: sinusoids + slow modulation + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    return x.astype(np.float32)


def rebuilt(source_ntc: np.ndarray, counters) -> np.ndarray:
    """The windows a ReplayBoard over `source_ntc` held when its counter
    read each of `counters`: [len(counters), T, C]."""
    stream = np.concatenate(list(source_ntc), axis=0).astype(np.float64)  # as the board keeps it
    total = stream.shape[0]
    idx = (np.asarray(counters)[:, None] - T + 1 + np.arange(T)[None, :]) % total
    return stream[idx].astype(np.float32)


@pytest.fixture(scope="module")
def small_lstm(tmp_path_factory):
    """A 2-layer LSTM of hidden 8 from the JAX registry's init, saved once
    with the JAX writer; both engines load the same file."""
    path = tmp_path_factory.mktemp("stream") / "lstm_small.npz"
    jax_save_npz(path, jax_get_model("lstm", **SMALL_LSTM).init(jax_random.PRNGKey(7)))
    return path


@pytest.fixture(scope="module")
def engines(small_lstm):
    ours = InferenceEngine(str(small_lstm), model_kw=SMALL_LSTM, class_names=CLASSES, device="cpu")
    theirs = JaxEngine(str(small_lstm), model_kw=SMALL_LSTM, class_names=CLASSES)
    return ours, theirs


def check_against(preds, source, jax_engine, average_n):
    want = jax_engine.predict_batch(rebuilt(source, [p.counter for p in preds]))
    got = np.stack([p.probs for p in preds])
    assert np.abs(got - want).max() <= PROB_TOL
    assert [p.label for p in preds] == [jax_engine.class_names[i] for i in want.argmax(1)]
    for i, p in enumerate(preds):
        expect = want[max(0, i - average_n + 1) : i + 1].mean(axis=0)
        assert np.abs(p.avg_probs - expect).max() <= PROB_TOL


def test_stream_decode_sliding_windows(engines):
    """(test_stream) 6 sliding windows at 256x real time, average over 5:
    each prediction and rolling average against the JAX engine on the
    window rebuilt from its counter; counters advance by at least a hop;
    exactly the returned windows were decoded."""
    engine, jax_engine = engines
    before = engine.stats["windows"]
    source = raw_windows(4, 0)
    dec = StreamDecoder(engine, ReplayBoard(source, speed=256.0), window_seconds=5.0,
                        hop_seconds=1.0, average_n=5)
    seen = []
    preds, stats = dec.run(6, on_prediction=seen.append, timeout=10)
    assert len(preds) == len(seen) == stats.windows == stats.latency.count == stats.fetch_wait.count == 6
    assert [p.index for p in preds] == list(range(6))
    for p in preds:
        assert p.probs.shape == (3,) and abs(p.probs.sum() - 1.0) < 1e-5
    counters = [p.counter for p in preds]
    assert all(b - a >= 125 for a, b in zip(counters, counters[1:]))
    assert engine.stats["windows"] - before == 6
    check_against(preds, source, jax_engine, average_n=5)


def test_stream_timeout_returns_partial(engines):
    """(test_stream) More predictions than the timeout allows: a partial
    result, no hang, every returned window still right."""
    engine, jax_engine = engines
    source = raw_windows(2, 1)
    dec = StreamDecoder(engine, ReplayBoard(source, speed=64.0), window_seconds=5.0, hop_seconds=5.0)
    preds, stats = dec.run(1000, timeout=1.5, warm=False)
    assert 0 < len(preds) < 1000 and stats.windows == len(preds)
    check_against(preds, source, jax_engine, average_n=10)


def test_stream_logcov_guard_stats_match_jax():
    """(b) The logcov engine parks its guard flags on asynchronous calls:
    after a stream, `stats` equals the JAX engine's on the same windows.
    The first flagship member with its channel-5 whitener gain cut to 0.18,
    on windows whose channel 5 is a 0.002 sinusoid, fires the guard."""
    params = jax_load_npz(CKPT / "logcov8wd_ens_s0.npz")
    params["whitener"] = (
        params["whitener"] * np.where(np.arange(8) == 5, 0.18, 1.0)[None, None, :]
    ).astype(np.float32)
    kw = dict(params=params, model="logcov8", model_kw={"whiten": True, "dropout": 0.0})
    engine = InferenceEngine(device="cpu", **kw)
    source = raw_windows(3, 2)
    source[:, :, 5] = 0.002 * np.sin(np.arange(T) * 0.3)
    dec = StreamDecoder(engine, ReplayBoard(source, speed=128.0), hop_seconds=1.0, average_n=3)
    preds, _ = dec.run(4, timeout=10)
    assert len(preds) == 4
    jax_engine = JaxEngine(**kw)
    check_against(preds, source, jax_engine, average_n=3)
    assert engine.stats == jax_engine.stats
    assert engine.stats["windows"] == 4 and engine.stats["guard_flagged"] > 0


def test_stream_cli_cpu(tmp_path, capsys):
    """The CLI streams a replay of recorded trials on --device cpu."""
    np.save(tmp_path / "w.npy", raw_windows(2, 3))
    main(["--board", f"replay:{tmp_path / 'w.npy'}", "--speed", "128", "--predictions", "2",
          "--model", str(CKPT / "lstm3_retrained.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("latency=") == 2 and "2 windows" in out


def test_stream_cli_without_cuda_raises():
    """No CUDA and no --device: the CLI raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--board", "synthetic", "--predictions", "1"])
