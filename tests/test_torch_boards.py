"""The port's boards on the CPU: the native C++ board and DSP (the port
builds its own library with g++), the serial board over a PTY, the
BrainFlow adapter over a fake brainflow module, and replay of recorded
trial CSVs, against the JAX package's copies where both exist.
"""

import os
import pty
import shutil
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch

from neural_speech_decoding_tpu.ops.iir import butter_sos as jax_butter_sos
from neural_speech_decoding_tpu.runtime.board import ReplayBoard as JaxReplayBoard
from neural_speech_decoding_tpu_torch.collector.chain import write_trial_csv
from neural_speech_decoding_tpu_torch.runtime import native
from neural_speech_decoding_tpu_torch.runtime.board import NativeBoard, ReplayBoard, open_board
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.serial_board import SerialBoard
from neural_speech_decoding_tpu_torch.runtime.tester import run_trials_ex

REPO = Path(__file__).resolve().parents[1]
NPZ3 = REPO / "checkpoints" / "lstm3_retrained.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seeded_trials(n: int, seed: int) -> np.ndarray:
    """Trial-like windows [n, 625, 8], rounded as the collector writes them."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((n, 625, 8)) * 5.0, 7)


@pytest.fixture(scope="module")
def trial_dir(tmp_path_factory):
    """Three recorded trials as the collector writes them."""
    d = tmp_path_factory.mktemp("trials")
    for i, (label, w) in enumerate(zip(("food", "water", "backgroundnoise"), seeded_trials(3, 0))):
        write_trial_csv(d / f"{label}_{i:04d}.csv", w)
    return d


def _drain(board, n=625, timeout=10.0):
    deadline = time.time() + timeout
    while board.get_board_data_count() < n and time.time() < deadline:
        time.sleep(0.01)
    return board.get_current_board_data(n)


# -- native board (test_native_board) ------------------------------------------
def test_native_library_is_the_ports_own_build():
    lib = native.library_path()
    assert native.build() == lib and lib.is_file()
    assert lib.parent == REPO / "build" / "nsd_torch_native"
    assert lib.name.startswith("libnsdboard-") and lib != REPO / "native" / "build" / "libnsdboard.so"


def test_native_synthetic_stream():
    b = NativeBoard("synthetic", speed=64.0)
    b.prepare_session()
    b.start_stream(buffer_size=5000)
    data = _drain(b)
    b.release_session()
    assert data.shape == (9, 625)
    assert (np.diff(data[0]) == 1).all()  # counter row
    eeg = data[b.eeg_channels, :]
    assert np.isfinite(eeg).all() and eeg.std() > 0.1


def test_native_replay_reproduces_trials(trial_dir):
    """native-replay:<dir> streams the CSVs' samples, in order, looping."""
    b = open_board(f"native-replay:{trial_dir}", speed=128.0)
    assert isinstance(b, NativeBoard)
    b.prepare_session()
    b.start_stream(buffer_size=5000)
    data = _drain(b)
    b.release_session()
    order = (2, 0, 1)  # the files sorted by name: backgroundnoise, food, water
    src = np.concatenate(list(seeded_trials(3, 0)[list(order)]), axis=0).astype(np.float32)  # [T, C]
    idx = (int(data[0, 0]) + np.arange(625)) % src.shape[0]
    np.testing.assert_array_equal(data[b.eeg_channels, :].T.astype(np.float32), src[idx])


def test_native_replay_requires_data():
    with pytest.raises(ValueError, match="replay_data"):
        NativeBoard("replay")


def test_native_board_through_run_trials(trial_dir):
    """Full stack: C++ engine -> connector -> producer -> the port's engine."""
    board = open_board(f"native-replay:{trial_dir}", speed=128.0)
    engine = InferenceEngine(str(NPZ3), class_names=("Food", "Water", "None"), device="cpu")
    result, stats = run_trials_ex(trials=2, serial_port=board, verbose=False, engine=engine)
    assert result.trials == 2
    assert result.avg_probs.shape == (3,)
    assert stats.latency.count == 2


def test_native_realtime_pacing():
    """At speed 1 the C++ producer paces to the sample rate: 50 samples
    (ten pushes of 5, the first at once) cannot arrive before 9 x 40 ms."""
    b = NativeBoard("synthetic", speed=1.0)
    b.prepare_session()
    t0 = time.perf_counter()
    b.start_stream(buffer_size=5000)
    data = _drain(b, n=50, timeout=10.0)
    elapsed = time.perf_counter() - t0
    b.release_session()
    assert data.shape == (9, 50)
    assert elapsed >= 0.36 - 0.02


def test_native_dsp_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 625)) + 3.0
    d = native.native_detrend_constant(x)
    np.testing.assert_allclose(d.mean(axis=1), 0.0, atol=1e-12)

    sos = np.asarray(jax_butter_sos("bandpass", 2, 3.0, 48.0, 125.0))
    causal = native.native_sosfilt(x, sos)
    np.testing.assert_allclose(causal, scipy.signal.sosfilt(sos, x, axis=1), rtol=1e-12, atol=1e-12)
    zp = native.native_sosfilt(x, sos, zero_phase=True)
    fwd = scipy.signal.sosfilt(sos, x, axis=1)
    ref_zp = scipy.signal.sosfilt(sos, fwd[:, ::-1], axis=1)[:, ::-1]
    np.testing.assert_allclose(zp, ref_zp, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="sos"):
        native.native_sosfilt(x, np.zeros((2, 5)))


def test_native_build_failure_raises_with_compiler_log(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with g++'s log."""
    for name in native.SOURCES:
        shutil.copy(native.NATIVE_DIR / name, tmp_path / name)
    with open(tmp_path / "nsd_dsp.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed") as exc:
        native.build()
    assert "nsd_dsp.cpp" in str(exc.value) and "error" in str(exc.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_library_env_override(monkeypatch, tmp_path):
    """$NSD_NATIVE_LIB names a prebuilt library; a missing one raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("NSD_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(FileNotFoundError, match="NSD_NATIVE_LIB"):
        native.load_library()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("NSD_NATIVE_LIB", str(native.build()))
    assert native.load_library().nsd_board_create is not None


# -- replay of recorded trials ------------------------------------------------
def test_replay_board_over_trial_csvs_matches_jax(trial_dir, monkeypatch):
    """replay:<dir> and replay ($NSD_DATA_DIR) load the trial CSVs back to
    back, as the JAX board does."""
    ours = open_board(f"replay:{trial_dir}")
    assert isinstance(ours, ReplayBoard) and ours._data.shape == (8, 3 * 625)
    np.testing.assert_array_equal(ours._data, JaxReplayBoard(str(trial_dir))._data)
    monkeypatch.setenv("NSD_DATA_DIR", str(trial_dir))
    np.testing.assert_array_equal(open_board("replay")._data, ours._data)


# -- serial board (test_serial_board) -----------------------------------------
@pytest.fixture
def fake_device():
    """PTY whose master side streams trial samples as CSV lines."""
    master, slave = pty.openpty()
    path = os.ttyname(slave)
    stop = threading.Event()
    data = seeded_trials(1, 1)[0]  # [625, 8]

    def writer():
        i = 0
        os.set_blocking(master, False)  # drain config writes so the buffer never blocks
        while not stop.is_set():
            try:
                os.read(master, 4096)
            except (BlockingIOError, OSError):
                pass
            line = ",".join(f"{v:.7f}" for v in data[i % len(data)]) + "\n"
            try:
                os.write(master, line.encode())
            except BlockingIOError:
                time.sleep(0.001)
                continue
            except OSError:
                break
            i += 1
            if i % 50 == 0:
                time.sleep(0.001)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    yield path, data
    stop.set()
    t.join(timeout=2)
    assert not t.is_alive()
    for fd in (master, slave):
        os.close(fd)


def test_serial_board_streams(fake_device):
    path, data = fake_device
    b = SerialBoard(path, num_channels=8, sample_rate=125)
    b.prepare_session()
    b.config_board("chon_1_12")  # written to the device
    b.start_stream(5000)
    try:
        got = _drain(b, n=100, timeout=15)[:, -50:]
    finally:
        b.stop_stream()
        b.release_session()
    assert got.shape == (9, 50)
    for row in got[b.eeg_channels, :].T:  # each sample is one of the source rows
        assert np.abs(data - row).max(axis=1).min() < 1e-6
    assert (np.diff(got[0]) > 0).all()
    assert "chon_1_12" in b.config_log


def test_serial_board_ignores_garbage_lines():
    """Echo/status lines and malformed frames are skipped."""
    master, slave = pty.openpty()
    b = SerialBoard(os.ttyname(slave), num_channels=8)
    b.prepare_session()
    b.start_stream(1000)
    try:
        os.write(master, b"OK registered\n")
        os.write(master, b"1.0,2.0\n")  # too few channels
        os.write(master, b"not,numbers,a,b,c,d,e,f\n")
        os.write(master, (",".join(f"{v:.4f}" for v in seeded_trials(1, 2)[0, 0]) + "\n").encode())
        _drain(b, n=1, timeout=10)
        assert b.get_board_data_count() == 1
    finally:
        os.close(master)  # the reader's next read fails, so its thread ends at once
        b.stop_stream()
        b.release_session()
        os.close(slave)


def test_serial_board_missing_device():
    with pytest.raises(FileNotFoundError):
        SerialBoard("/dev/does_not_exist_xyz").prepare_session()


# -- BrainFlow adapter (test_brainflow_board) ----------------------------------
def test_brainflow_spec_gated_without_package():
    try:
        import brainflow  # noqa: F401

        pytest.skip("brainflow unexpectedly present")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="brainflow"):
        open_board("brainflow:/dev/ttyUSB0")


def test_bare_port_spec_still_actionable():
    with pytest.raises(RuntimeError, match="brainflow:<port>"):
        open_board("/dev/cu.usbserial-FTB6SPL3")


@pytest.fixture()
def fake_brainflow(monkeypatch):
    """A minimal fake brainflow package that records calls."""
    calls = []

    class FakeShim:
        def __init__(self, board_id, params):
            calls.append(("init", board_id, params.serial_port))
            self._data = np.arange(9 * 100, dtype=np.float64).reshape(9, 100)

        @staticmethod
        def get_sampling_rate(board_id):
            return 125

        @staticmethod
        def get_exg_channels(board_id):
            return list(range(1, 9))

        def prepare_session(self):
            calls.append(("prepare",))

        def config_board(self, cmd):
            calls.append(("config", cmd))
            return "ok"

        def config_board_with_bytes(self, payload):
            calls.append(("config_bytes", payload))

        def start_stream(self, buffer_size):
            calls.append(("start", buffer_size))

        def stop_stream(self):
            calls.append(("stop",))

        def release_session(self):
            calls.append(("release",))

        def get_board_data_count(self):
            return self._data.shape[1]

        def get_current_board_data(self, n):
            return self._data[:, -n:]

    class FakeParams:
        def __init__(self):
            self.serial_port = ""

    class FakeIds:
        NEUROPAWN_KNIGHT_BOARD = 57

    mod = types.ModuleType("brainflow")
    shim_mod = types.ModuleType("brainflow.board_shim")
    shim_mod.BoardShim = FakeShim
    shim_mod.BrainFlowInputParams = FakeParams
    shim_mod.BoardIds = FakeIds
    mod.board_shim = shim_mod
    monkeypatch.setitem(sys.modules, "brainflow", mod)
    monkeypatch.setitem(sys.modules, "brainflow.board_shim", shim_mod)
    return calls


def test_adapter_maps_board_surface(fake_brainflow):
    board = open_board("brainflow:/dev/ttyUSB7")
    assert fake_brainflow[0] == ("init", 57, "/dev/ttyUSB7")
    assert board.get_board_id() == 57
    assert board.get_sampling_rate(board.get_board_id()) == 125
    assert board.get_exg_channels(board.get_board_id()) == list(range(1, 9))
    board.prepare_session()
    board.config_board("chon_1_12")
    board.config_board_with_bytes(b"rldadd_1")
    board.start_stream(450000)
    assert board.get_board_data_count() == 100
    assert board.get_current_board_data(10).shape == (9, 10)
    board.stop_stream()
    board.release_session()
    assert [c[0] for c in fake_brainflow] == [
        "init", "prepare", "config", "config_bytes", "start", "stop", "release",
    ]


def test_adapter_explicit_board_id(fake_brainflow):
    open_board("brainflow:/dev/ttyUSB0:2")
    assert fake_brainflow[0] == ("init", 2, "/dev/ttyUSB0")


def test_adapter_works_with_connector(fake_brainflow):
    from neural_speech_decoding_tpu_torch.runtime.connector import Connector

    conn = Connector("brainflow:/dev/ttyACM1", num_channels=8)
    conn.start_stream()
    assert conn.get_window(0.08).shape == (8, 10)  # 10 samples at 125 Hz
    conn.stop_stream()
    assert ("config_bytes", b"chon_1_12") in fake_brainflow


def test_adapter_works_with_stream_decoder(fake_brainflow):
    """StreamDecoder runs over the adapter (it reads board._streaming for
    session ownership); the static 100 samples hold one 0.2 s window."""
    from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder

    engine = InferenceEngine(str(NPZ3), device="cpu")
    decoder = StreamDecoder(engine, "brainflow:/dev/ttyS9", window_seconds=0.2,
                            hop_seconds=0.1, average_n=2)
    preds, _ = decoder.run(1, timeout=5, warm=False)
    assert len(preds) == 1 and preds[0].probs.shape == (3,)
    want = engine.predict_batch(np.arange(9 * 100, dtype=np.float64).reshape(9, 100)[1:, -25:].T[None])
    np.testing.assert_allclose(preds[0].probs, want[0], rtol=0, atol=1e-6)
    names = [c[0] for c in fake_brainflow]
    assert "prepare" in names and "start" in names and "release" in names
