"""The port's reference import surface (neural_speech_decoding_tpu_torch.
utilities) held against the JAX package's shim (`Utilities/`), and the
port's entry points (entry.py) against `__graft_entry__.py`, on
the CPU.

Inputs: board-like windows drawn with numpy from a seed, and a .pth
written by the JAX package's own writer (io/export.save_torch_checkpoint)
from checkpoints/lstm3_retrained.npz. The boards of both packages are
replay boards of the same seeded windows, whose producer pushes a fixed
number of samples once, so that a window read from either is the same.

Tolerances: SimplePredictor within 1e-4 |delta logit| and 1e-5
|delta prob| of the shim, labels equal; PreProcessor (both in float64,
then float32) within 1e-6 of the window's max |output|; board windows
and stream payloads exactly equal; entry()'s forward within 1e-5 in
probability of __graft_entry__'s on the same parameters and windows (the
fast filter's float32 rounding).
"""

import inspect
import json
import queue
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import Utilities.knight_board_init as jax_knight
import Utilities.lstm_eeg_model as jax_lstm_eeg_model
import Utilities.neurokit_connector as jax_neurokit
import Utilities.preprocessor as jax_preprocessor
import Utilities.streaming_process as jax_streaming
from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.lstm import decoder_apply as jax_decoder_apply
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter_batch as jax_mai_filter_batch
from neural_speech_decoding_tpu.runtime.board import ReplayBoard as JaxReplayBoard
from neural_speech_decoding_tpu_torch import entry as port_entry
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.runtime import tester as runtime_tester
from neural_speech_decoding_tpu_torch.runtime.board import ReplayBoard, SyntheticBoard
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
from neural_speech_decoding_tpu_torch.utilities import (
    knight_board_init,
    lstm_eeg_model,
    neurokit_connector,
    preprocessor,
    streaming_process,
    tester,
)

REPO = Path(__file__).resolve().parents[1]
NPZ3 = REPO / "checkpoints" / "lstm3_retrained.npz"
LOGIT_TOL = 1e-4
PROB_TOL = 1e-5
FILTER_REL_TOL = 1e-6
PUMPED = 1000  # samples each fixed-pump board holds
LEGACY_COMMANDS = [c for x in range(1, 9) for c in (f"chon_{x}_12", f"rldadd_{x}")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("utilities") / "lstm3.pth"
    save_torch_checkpoint(path, decoder_params_to_torch_state(jax_load_npz(NPZ3)))
    return str(path)


def board_like(n: int, seed: int) -> np.ndarray:
    """[n, 625, 8] float32: channel sinusoids with a slow drift and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(625) / 125.0
    ch = np.arange(8)
    x = np.sin(2 * np.pi * (8 + ch) * t[None, :, None] + rng.uniform(0, 2 * np.pi, (n, 1, 8)))
    x = x + 0.4 * np.sin(2 * np.pi * 2 * t[None, :, None] + ch)
    return (10.0 * (x + 0.3 * rng.standard_normal((n, 625, 8)))).astype(np.float32)


def fixed_pump(board_cls):
    """board_cls whose producer pushes PUMPED samples once, then idles, and
    which records each config command with whether the stream was on."""

    class FixedPump(board_cls):
        def _pump(self):
            self._ring.push(self._generate(0, PUMPED))
            self._stop.wait()

        def config_board_with_bytes(self, payload):
            self.sent = getattr(self, "sent", []) + [(payload.decode("ascii"), self._streaming)]
            super().config_board_with_bytes(payload)

    return FixedPump


def boards(seed: int = 3):
    """A fixed-pump replay board of each package over the same windows."""
    w = board_like(2, seed)
    return fixed_pump(ReplayBoard)(w, speed=64.0), fixed_pump(JaxReplayBoard)(w, speed=64.0)


def filled(*boards_):
    """Wait until each fixed-pump board holds its samples."""
    deadline = time.time() + 10
    while any(b.get_board_data_count() < PUMPED for b in boards_) and time.time() < deadline:
        time.sleep(0.005)


def test_tester_forwards_the_runtime():
    for name in ("DEFAULT_SERIAL", "TrialResult", "main", "run_trials", "run_trials_ex"):
        assert getattr(tester, name) is getattr(runtime_tester, name)


def test_simple_predictor_signature_matches_shim():
    """The same keywords and defaults as the shim, but device (None: CUDA)."""
    want = inspect.signature(jax_lstm_eeg_model.SimplePredictor.__init__).parameters
    got = inspect.signature(lstm_eeg_model.SimplePredictor.__init__).parameters
    assert list(got) == list(want)
    for k in want:
        if k != "device":
            assert got[k].default == want[k].default, k
    assert want["device"].default == "tpu" and got["device"].default is None
    assert lstm_eeg_model.CLASS_NAMES == jax_lstm_eeg_model.CLASS_NAMES


def test_simple_predictor_matches_shim(pth):
    """Eight windows: logits, probabilities and labels against the shim
    (both run the "highest" filter in float64)."""
    windows = board_like(8, seed=0)
    ours = lstm_eeg_model.SimplePredictor(pth, sr=125, device="cpu")
    theirs = jax_lstm_eeg_model.SimplePredictor(pth, sr=125)
    assert ours._engine.config.filter.precision == "highest"
    cfg = theirs._engine.config  # the shim's engine, its filter and decoder
    want = jax_decoder_apply(theirs._engine.params, jax_mai_filter_batch(windows, cfg.filter), cfg.decoder)
    assert np.abs(ours._engine.logits_batch(windows) - np.asarray(want)).max() <= LOGIT_TOL
    for w in windows:
        (p, label), (q, want_label) = ours.predict(w), theirs.predict(w)
        assert p.dtype == np.float32 and p.shape == (3,)
        assert np.abs(p - np.asarray(q)).max() <= PROB_TOL
        assert label == want_label


def test_simple_predictor_other_config(pth):
    """Custom class names and lambda reach the engine as in the shim."""
    names = ("a", "b", "c")
    ours = lstm_eeg_model.SimplePredictor(pth, sr=250, tailoring_lambda=1e-25, class_names=names, device="cpu")
    theirs = jax_lstm_eeg_model.SimplePredictor(pth, sr=250, tailoring_lambda=1e-25, class_names=names)
    w = board_like(1, seed=1)[0]
    (p, label), (q, want_label) = ours.predict(w), theirs.predict(w)
    assert label == want_label and label in names
    assert np.abs(p - np.asarray(q)).max() <= PROB_TOL
    assert ours._engine.config.sample_rate == 250 and ours._engine.config.filter.lambd == 1e-25


def test_preprocessor_matches_shim():
    ours = preprocessor.PreProcessor(sr=125, device="cpu")
    theirs = jax_preprocessor.PreProcessor(sr=125)
    for w in board_like(3, seed=2):
        got, want = ours.transform(w), theirs.transform(w)
        assert got.dtype == np.float32 and got.shape == (625, 8)
        assert np.abs(got - want).max() <= FILTER_REL_TOL * np.abs(want).max()
    with pytest.raises(ValueError, match=r"Expected 2D array \[samples, channels\], got \(10,\)"):
        ours.transform(np.zeros((10,)))


def test_neurokit_connector_matches_shim():
    port_board, jax_board = boards()
    ours, theirs = neurokit_connector.NeuroPawnConnector(port_board), jax_neurokit.NeuroPawnConnector(jax_board)
    assert ours.params is None and theirs.params is None
    for c in (ours, theirs):
        c.start_stream()
    filled(port_board, jax_board)
    try:
        got, want = ours.get_window(5.0), theirs.get_window(5.0)
    finally:
        for c in (ours, theirs):
            c.stop_stream()
    assert got.shape == (8, 625) and np.array_equal(got, want)
    assert (ours.sr, ours.eeg_channels) == (theirs.sr, theirs.eeg_channels)


def test_knight_board_legacy_order_matches_shim():
    port_board, jax_board = boards()
    ours, theirs = knight_board_init.KnightBoard(port_board, 8), jax_knight.KnightBoard(jax_board, 8)
    assert ours.board_shim is port_board
    with pytest.raises(RuntimeError, match="before start_stream"):
        ours.get_window(5.0)
    for k in (ours, theirs):
        k.start_stream()
    filled(port_board, jax_board)
    try:
        got, want = ours.get_window(5.0), theirs.get_window(5.0)
    finally:
        for k in (ours, theirs):
            k.stop_stream()
    assert got.shape == (8, 625) and np.array_equal(got, want)
    # the legacy order: 16 commands, each sent once the stream is on
    assert port_board.sent == [(c, True) for c in LEGACY_COMMANDS] == jax_board.sent
    assert port_board.config_log == LEGACY_COMMANDS


def _first_payload(process_cls, board):
    q = queue.Queue(maxsize=8)
    proc = process_cls(board, out_queue=q)
    proc.start()
    proc.recording_flag.value = True
    try:
        return q.get(timeout=15)
    finally:
        proc.recording_flag.value = False
        proc.stop()
        proc.join(timeout=5)


def test_streaming_process_matches_shim():
    port_board, jax_board = boards()
    got = _first_payload(streaming_process.StreamingProcess, port_board)
    want = _first_payload(jax_streaming.StreamingProcess, jax_board)
    assert got["data"].shape == (625, 8) and got["data"].dtype == np.float32
    assert np.array_equal(got["data"], want["data"])
    assert got["sr"] == want["sr"] == 125 and list(got["channels"]) == list(want["channels"])


def test_run_trials_through_utilities(pth):
    result = tester.run_trials(trials=2, serial_port=SyntheticBoard(speed=64.0), model_path=pth,
                               verbose=False, device="cpu")
    assert result.trials == 2 and result.avg_probs.shape == (3,)
    assert abs(float(result.avg_probs.sum()) - 1.0) <= 1e-5
    assert result.avg_chunk.shape == (625, 8)


def test_tester_cli_combine_flag(monkeypatch, tmp_path):
    """--combine median reaches EnsembleEngine.from_manifest (manifest
    serving is the only path it applies to), as for the JAX shim."""
    manifest = tmp_path / "ens_manifest.json"
    manifest.write_text(json.dumps({"model": "tcn_small", "members": []}))
    seen = {}

    def fake_from_manifest(path, **kw):
        seen.update(kw, path=path)
        return object()

    class _Stats:
        windows_per_second = 1.0
        latency = {}

    monkeypatch.setattr(EnsembleEngine, "from_manifest", staticmethod(fake_from_manifest))
    monkeypatch.setattr(runtime_tester, "run_trials_ex", lambda **kw: ("ok", _Stats()))
    tester.main(["--model", str(manifest), "--combine", "median", "--device", "cpu"])
    assert seen["combine"] == "median" and seen["path"] == str(manifest) and seen["device"] == "cpu"


def test_entry_forward_matches_graft_entry():
    """entry()'s forward against __graft_entry__.entry()'s on the shipped
    npz (through params_from_jax) and the same windows."""
    jfn, (_, jwindows) = __graft_entry__.entry()
    fn, (params, windows) = port_entry.entry(device="cpu")
    assert np.array_equal(windows, jwindows) and windows.shape == (8, 625, 8)
    want = np.asarray(jax.jit(jfn)(jax_load_npz(NPZ3), jwindows))
    got = fn(params, windows)
    assert got.shape == (8, 3) and got.device.type == "cpu"
    assert np.abs(got.numpy() - want).max() <= PROB_TOL
    ref = load_params_npz(NPZ3)
    assert np.array_equal(params["fc2"]["w"].numpy(), ref["fc2"]["w"])


def test_dryrun_multichip_cpu_repeated(capsys):
    out = port_entry.dryrun_multichip(2, devices=["cpu"] * 2)
    assert (out["dp"], out["tp"], out["ensemble_members"]) == (2, 1, 5)
    assert np.isfinite(out["loss"]) and np.isfinite(out["logcov8_loss"])
    assert out["kernel_vs_stages_max_delta"] <= 1e-5
    assert "dryrun_multichip ok: mesh dp=2 tp=1" in capsys.readouterr().out


def test_dryrun_multichip_families_and_devices(capsys):
    out = port_entry.dryrun_multichip(3, families=("lstm",), devices=["cpu"] * 3)
    assert out["dp"] == 3 and "logcov8_loss" not in out and "ensemble_members" not in out
    with pytest.raises(ValueError, match="2 devices given"):
        port_entry.dryrun_multichip(3, devices=["cpu"] * 2)
    port_entry.main(["2", "--device", "cpu"])
    port_entry.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2" in text and "entry ok: (8, 3)" in text


def test_surface_without_cuda_raises(pth, monkeypatch):
    """No CUDA and no device named: each entry point raises, before any
    stream starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: lstm_eeg_model.SimplePredictor(pth, sr=125),
        lambda: preprocessor.PreProcessor(sr=125),
        lambda: tester.run_trials(trials=1, serial_port=SyntheticBoard(speed=64.0), model_path=pth, verbose=False),
        lambda: port_entry.entry(),
        lambda: port_entry.dryrun_multichip(2),
        lambda: port_entry.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(2, devices=["cuda:0"] * 2)
