"""The port's runtime on the CPU: boards, streaming producer, run_trials,
and the timing helpers, against the JAX package's copies where both exist.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.runtime.board import RingBuffer as JaxRingBuffer
from neural_speech_decoding_tpu.runtime.board import SyntheticBoard as JaxSyntheticBoard
from neural_speech_decoding_tpu_torch.runtime import board as board_mod
from neural_speech_decoding_tpu_torch.runtime.board import ReplayBoard, RingBuffer, SyntheticBoard, open_board
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.streaming import StreamingProducer
from neural_speech_decoding_tpu_torch.runtime.tester import run_trials, run_trials_ex
from neural_speech_decoding_tpu_torch.utils.timing import LatencyStats, Stopwatch

REPO = Path(__file__).resolve().parents[1]
NPZ3 = REPO / "checkpoints" / "lstm3_retrained.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_synthetic_board_samples_match_jax():
    ours, theirs = SyntheticBoard(seed=3), JaxSyntheticBoard(seed=3)
    for start in (0, 5, 625):
        np.testing.assert_array_equal(ours._generate(start, 5), theirs._generate(start, 5))


def test_ring_buffer_wraps_like_jax():
    ours, theirs = RingBuffer(2, 7), JaxRingBuffer(2, 7)
    for k in (3, 4, 5, 1):
        block = np.arange(2 * k, dtype=np.float64).reshape(2, k) + k
        ours.push(block)
        theirs.push(block)
        assert ours.count() == theirs.count()
        for n in (1, 4, 9):
            np.testing.assert_array_equal(ours.latest(n), theirs.latest(n))


def test_open_board_specs(tmp_path, monkeypatch):
    """Every spec of the JAX package's open_board resolves: synthetic,
    replay of a .npy array or of a trial-CSV directory ($NSD_DATA_DIR when
    bare), the native C++ boards, serial:<device>, brainflow:<port> (an
    actionable ImportError without the package), and an unadapted port
    (RuntimeError naming the serial port)."""
    from neural_speech_decoding_tpu_torch.runtime.serial_board import SerialBoard

    assert isinstance(open_board("synthetic"), SyntheticBoard)
    path = tmp_path / "w.npy"
    np.save(path, np.ones((2, 625, 8), np.float32))
    replay = open_board(f"replay:{path}")
    assert isinstance(replay, ReplayBoard) and replay._data.shape == (8, 1250)
    trials = tmp_path / "trials"
    trials.mkdir()
    np.savetxt(trials / "food_0.csv", np.full((625, 8), 0.5), delimiter=",", fmt="%.7f")
    assert ReplayBoard(str(trials))._data.shape == (8, 625)
    monkeypatch.delenv("NSD_DATA_DIR", raising=False)
    for spec in ("replay", "native-replay"):
        with pytest.raises(FileNotFoundError, match="NSD_DATA_DIR"):
            open_board(spec)
    monkeypatch.setenv("NSD_DATA_DIR", str(trials))
    assert open_board("replay")._data.shape == (8, 625)
    native = open_board("native-replay", speed=2.0)
    assert isinstance(native, board_mod.NativeBoard) and native.speed == 2.0
    native.release_session()
    synthetic = open_board("native-synthetic")
    assert isinstance(synthetic, board_mod.NativeBoard)
    synthetic.release_session()
    serial = open_board("serial:/dev/null")
    assert isinstance(serial, SerialBoard) and serial.device_path == "/dev/null"
    with pytest.raises(ImportError, match="brainflow"):
        open_board("brainflow:COM3")
    with pytest.raises(RuntimeError, match="serial port"):
        open_board("/dev/ttyUSB0")
    with pytest.raises(ValueError, match="2D/3D"):
        ReplayBoard(np.zeros((5,), np.float32))


def test_streaming_producer_emits_windows():
    prod = StreamingProducer(SyntheticBoard(speed=64.0), window_seconds=1.0)
    prod.start()
    prod.recording_flag.value = True
    try:
        item = prod.out_queue.get(timeout=10)
        assert item["data"].shape == (125, 8) and item["data"].dtype == np.float32
        assert item["sr"] == 125
    finally:
        prod.recording_flag.value = False
        prod.stop()
        prod.join(timeout=5)
    assert not prod.is_alive()


def test_run_trials_on_cpu():
    """(g) run_trials end to end on a fast synthetic board: the lazily built
    engine decodes 3 windows; reference class-name quirk kept."""
    result, stats = run_trials_ex(
        trials=3,
        serial_port=SyntheticBoard(speed=64.0),
        model_path=str(NPZ3),
        verbose=False,
        device="cpu",
    )
    assert result.trials == 3
    assert result.avg_probs.shape == (3,)
    assert np.isfinite(result.avg_probs).all()
    assert abs(float(result.avg_probs.sum()) - 1.0) < 1e-5
    assert result.avg_chunk.shape == (625, 8)
    assert stats.latency.count == 3 and stats.windows_per_second > 0
    assert set(stats.labels) <= {"Food", "Water", "None"}


def test_run_trials_with_engine_and_replay():
    windows = np.random.default_rng(0).standard_normal((3, 625, 8)).astype(np.float32)
    engine = InferenceEngine(str(NPZ3), device="cpu")
    result, stats = run_trials_ex(
        trials=2,
        serial_port=ReplayBoard(windows, speed=128.0),
        verbose=False,
        engine=engine,
    )
    assert result.trials == 2 and len(stats.labels) == 2
    assert set(stats.labels) <= set(engine.class_names)
    assert engine.stats["windows"] == 2


def test_run_trials_needs_cuda_without_device(monkeypatch):
    """(h) No CUDA and no explicit device: raise before streaming starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_trials(trials=1, serial_port=SyntheticBoard(speed=64.0), model_path=str(NPZ3), verbose=False)


def test_timing_helpers():
    stats = LatencyStats(name="x")
    assert str(stats) == "x: no samples"
    for v in (0.003, 0.001, 0.002):
        stats.record(v)
    s = stats.summary()
    assert s["count"] == 3 and s["min"] == 0.001 and s["p50"] == 0.002 and s["max"] == 0.003
    sw = Stopwatch()
    time.sleep(0.001)
    assert sw.lap() > 0
