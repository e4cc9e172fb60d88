"""The port's collector on the CPU: the per-stage zero-phase IIR family and
the collector chain of ops/iir.py (against the JAX package with x64: the
port's float64 within 1e-10 of JAX's, its float32 within 1e-5 of the
window's scale, max |input|, of JAX's float64 value; against scipy and
the port-built native DSP), the recording chain (CSV bytes equal to
JAX's), the headless experiment (JAX's word order), the stimulus
presenters and the .psyexp parser.
"""

import io
import json
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from neural_speech_decoding_tpu.collector.chain import record_trial as jax_record_trial
from neural_speech_decoding_tpu.collector.experiment import ExperimentConfig as JaxExperimentConfig
from neural_speech_decoding_tpu.collector.experiment import full_random_order as jax_full_random_order
from neural_speech_decoding_tpu.collector.psyexp import load_psyexp as jax_load_psyexp
from neural_speech_decoding_tpu.ops import iir as jax_iir
from neural_speech_decoding_tpu_torch.collector.chain import preprocess_trial, record_trial, write_trial_csv
from neural_speech_decoding_tpu_torch.collector.experiment import (
    ExperimentConfig,
    full_random_order,
    load_words_csv,
    main as experiment_main,
    run_experiment,
)
from neural_speech_decoding_tpu_torch.collector.psyexp import load_psyexp
from neural_speech_decoding_tpu_torch.collector.stimulus import TerminalPresenter
from neural_speech_decoding_tpu_torch.collector.web_stimulus import WebPresenter
from neural_speech_decoding_tpu_torch.io.dataset import load_trials
from neural_speech_decoding_tpu_torch.ops import iir
from neural_speech_decoding_tpu_torch.runtime import native
from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard, open_board

REPO = Path(__file__).resolve().parents[1]
F64_TOL = 1e-10
F32_SCALE_TOL = 1e-5
BANDSTOP = iir.butter_sos("bandstop", 4, 59.0, 61.0, 125.0)
BANDPASS = iir.butter_sos("bandpass", 2, 3.0, 48.0, 125.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def noise():
    return np.random.default_rng(0).standard_normal((625, 8)) * 3.0 + 1.0


def board_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, 625, 8] in float64: sinusoids, slow
    modulation, noise and a per-channel offset."""
    rng = np.random.default_rng(seed)
    t = np.arange(625) / 125.0
    ch = np.arange(8)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 8))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase)
    x = x + 3.0 * np.sin(2 * np.pi * 60 * t[:, None]) + rng.uniform(-5, 5, (n, 1, 8))
    return x + 0.35 * rng.standard_normal((n, 625, 8))


def rel_err(got, want, x) -> float:
    """max |got - want| over the scale of each input window x, max |x|
    ([T, C] or [B, T, C]): a linear filter's float32 rounding scales with
    the signal that runs through it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    axes = tuple(range(want.ndim - 2, want.ndim))
    return float((np.abs(got - want) / np.abs(x).max(axis=axes, keepdims=True)).max())


# -- per-stage IIR (test_iir) ---------------------------------------------------
def test_sosfilt_zi_and_padlen_match_jax_and_scipy():
    for sos in (BANDSTOP, BANDPASS):
        np.testing.assert_allclose(iir.sosfilt_zi(sos), scipy.signal.sosfilt_zi(np.asarray(sos)), rtol=1e-12)
        np.testing.assert_array_equal(iir.sosfilt_zi(sos), jax_iir.sosfilt_zi(sos))
        assert iir.default_padlen(sos) == jax_iir.default_padlen(sos)
    assert iir.butter_sos("lowpass", 4, 0.0, 30.0, 125.0) == jax_iir.butter_sos("lowpass", 4, 0.0, 30.0, 125.0)


STAGES = {
    "sosfilt": lambda mod, sos, x: mod.sosfilt(sos, x),
    "sosfilt_parallel": lambda mod, sos, x: mod.sosfilt_parallel(sos, x),
    "sosfiltfilt-none": lambda mod, sos, x: mod.sosfiltfilt(sos, x, padtype=None),
    "sosfiltfilt-odd": lambda mod, sos, x: mod.sosfiltfilt(sos, x),
    "sosfiltfilt_parallel-none": lambda mod, sos, x: mod.sosfiltfilt_parallel(sos, x, padtype=None),
    "sosfiltfilt_parallel-odd": lambda mod, sos, x: mod.sosfiltfilt_parallel(sos, x),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_jax(stage, noise):
    """Each per-stage function on the narrow 59-61 Hz bandstop (poles at
    radius 0.947-0.988): float64 within 1e-10 of JAX's (jitted, x64), and
    float32 within 1e-5 of the window's scale of that float64 value."""
    fn = STAGES[stage]
    noise = noise.astype(np.float32).astype(np.float64)  # one input for both dtypes
    want = np.asarray(jax.jit(lambda x: fn(jax_iir, BANDSTOP, x))(jnp.asarray(noise)))
    got = fn(iir, BANDSTOP, torch.from_numpy(noise))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= F64_TOL
    got32 = fn(iir, BANDSTOP, torch.from_numpy(noise.astype(np.float32)))
    assert got32.dtype == torch.float32
    assert rel_err(got32.numpy(), want, noise) <= F32_SCALE_TOL


def test_sosfilt_matches_scipy(noise):
    got = iir.sosfilt(BANDPASS, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, scipy.signal.sosfilt(np.asarray(BANDPASS), noise, axis=0), rtol=1e-9, atol=1e-9)
    par = iir.sosfilt_parallel(BANDPASS, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(par, got, rtol=1e-9, atol=1e-9)


def test_sosfiltfilt_matches_scipy(noise):
    ref = scipy.signal.sosfiltfilt(np.asarray(BANDSTOP), noise, axis=0)
    for fn in (iir.sosfiltfilt, iir.sosfiltfilt_parallel):
        np.testing.assert_allclose(fn(BANDSTOP, torch.from_numpy(noise)).numpy(), ref, rtol=1e-7, atol=1e-8)


def test_sosfiltfilt_no_padding_is_forward_backward(noise):
    fwd = scipy.signal.sosfilt(np.asarray(BANDPASS), noise, axis=0)
    ref = scipy.signal.sosfilt(np.asarray(BANDPASS), fwd[::-1], axis=0)[::-1]
    got = iir.sosfiltfilt(BANDPASS, torch.from_numpy(noise), padtype=None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_detrend_and_padlen_checks():
    x = np.random.default_rng(1).standard_normal((100, 4)) + 7.5
    out = iir.detrend_constant(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-12)
    np.testing.assert_allclose(out, np.asarray(jax_iir.detrend_constant(jnp.asarray(x))), rtol=0, atol=1e-14)
    for fn in (iir.sosfiltfilt, iir.sosfiltfilt_parallel):
        with pytest.raises(ValueError, match="padlen"):
            fn(BANDPASS, torch.zeros((10, 2), dtype=torch.float64), padlen=10)
        with pytest.raises(ValueError, match="padtype"):
            fn(BANDPASS, torch.zeros((100, 2), dtype=torch.float64), padtype="even")
    with pytest.raises(ValueError, match="sos"):
        iir.sosfilt(np.zeros((2, 5)), torch.zeros((10, 2)))


# -- the collector chain ----------------------------------------------------------
@pytest.fixture(scope="module")
def chain_reference():
    """JAX's collector chain (matmul, x64) on board-like windows that
    float32 holds exactly, for each padtype. JAX's three methods agree in
    float64 to about 3e-13 here; with x64 on, JAX runs the chain in
    float64 whatever the input's dtype."""
    x = board_windows(2, 0).astype(np.float32).astype(np.float64)
    return x, {pt: np.asarray(jax_iir.collector_filter_chain_batch(jnp.asarray(x), 125.0, pt, "matmul"))
               for pt in (None, "odd")}


@pytest.mark.parametrize("padtype", [None, "odd"])
@pytest.mark.parametrize("method", ["matmul", "parallel", "scan"])
def test_chain_matches_jax(method, padtype, chain_reference):
    """collector_filter_chain_batch by each method: float64 within 1e-10
    of JAX's chain; float32 within 1e-5 of each window's scale of it."""
    x, ref = chain_reference
    want = ref[padtype]
    got = iir.collector_filter_chain_batch(torch.from_numpy(x), 125.0, padtype, method)
    assert got.dtype == torch.float64 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= F64_TOL
    got32 = iir.collector_filter_chain_batch(torch.from_numpy(x.astype(np.float32)), 125.0, padtype, method)
    assert got32.dtype == torch.float32
    assert rel_err(got32.numpy(), want, x) <= F32_SCALE_TOL


def test_chain_scan_matches_jax_scan():
    """The sequential chain against JAX's own sequential chain (x64)."""
    x = board_windows(1, 4)[0]
    want = np.asarray(jax_iir.collector_filter_chain(jnp.asarray(x), 125.0, "odd", method="scan"))
    got = iir.collector_filter_chain(torch.from_numpy(x), 125.0, "odd", method="scan")
    assert np.abs(got.numpy() - want).max() <= F64_TOL


def test_chain_suppresses_line_noise():
    """60 Hz mains and a 40 Hz artefact on a 10 Hz signal are crushed; the
    10 Hz content survives."""
    fs = 125.0
    t = np.arange(625) / fs
    base = np.sin(2 * np.pi * 10 * t)
    mains = 3.0 * np.sin(2 * np.pi * 60 * t)
    forty = 2.0 * np.sin(2 * np.pi * 40 * t)
    x = np.stack([base + mains + forty] * 8, axis=1)
    sig = iir.collector_filter_chain(torch.from_numpy(x), fs).numpy()[:, 0]

    def band_power(s, f):
        spec = np.abs(np.fft.rfft(s))
        idx = int(round(f * len(s) / fs))
        return spec[idx - 1 : idx + 2].max()

    assert band_power(sig, 10) > 0.5 * band_power(base, 10)
    assert band_power(sig, 60) < 0.02 * band_power(mains + base, 60)
    assert band_power(sig, 40) < 0.05 * band_power(forty + base, 40)


def test_chain_batch_methods_agree(noise):
    batch = np.stack([noise, noise * 2])
    single = iir.collector_filter_chain(torch.from_numpy(noise)).numpy()
    for method in ("matmul", "parallel", "scan"):
        out = iir.collector_filter_chain_batch(torch.from_numpy(batch), method=method).numpy()
        np.testing.assert_allclose(out[0], single, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out[1], 2 * single, rtol=1e-7, atol=1e-7)
    with pytest.raises(ValueError, match="method"):
        iir.collector_filter_chain_batch(torch.from_numpy(batch), method="fft")


def _native_chain(x_tc: np.ndarray) -> np.ndarray:
    x_ct = native.native_detrend_constant(x_tc.T)  # the native DSP works along the last axis
    for kind, order, lo, hi in iir._COLLECTOR_STAGES:
        x_ct = native.native_sosfilt(x_ct, np.asarray(iir.butter_sos(kind, order, lo, hi, 125.0)), zero_phase=True)
    return x_ct.T


def test_chain_matches_native_dsp():
    """(test_collector_chain_matches_native_dsp, on synthetic windows) The
    chain and the C++ DSP (native/nsd_dsp.cpp, built by the port) are two
    renderings of BrainFlow's detrend + pad-free zero-phase chain: every
    method within 1e-9 in float64; the rounded trial within 2e-7; the
    scipy-padded variant differs at the edges."""
    for w in board_windows(3, 1):
        theirs = _native_chain(w)
        for method in ("matmul", "parallel", "scan"):
            ours = iir.collector_filter_chain_batch(torch.from_numpy(w[None]), method=method)[0].numpy()
            assert np.abs(ours - theirs).max() <= 1e-9, method
    w = board_windows(1, 2)[0]
    rounded = np.round(_native_chain(w), 7)
    rounded[rounded == 0.0] = 0.0
    np.testing.assert_allclose(preprocess_trial(w, device="cpu"), rounded, rtol=0, atol=2e-7)
    assert np.abs(preprocess_trial(w, padtype="odd", device="cpu") - rounded).max() > 1e-4


# -- recording chain (test_collector) --------------------------------------------
class _FixedBoard:
    """A board whose latest samples are a fixed [rows, T] array."""

    eeg_channels = list(range(1, 9))

    def __init__(self, data_ct):
        self._data = np.vstack([np.arange(data_ct.shape[1])[None], data_ct])

    def get_board_id(self):
        return -1

    def get_sampling_rate(self, board_id=-1):
        return 125

    def get_current_board_data(self, n):
        return self._data[:, -n:]


def test_preprocess_trial_format():
    raw = np.random.default_rng(0).standard_normal((625, 8)) * 10 + 3
    out = preprocess_trial(raw, device="cpu")
    assert out.shape == (625, 8)
    np.testing.assert_array_equal(out, np.round(out, 7))
    assert not np.any((out == 0.0) & np.signbit(out))  # no negative zeros
    assert np.abs(out.mean(axis=0)).max() < 0.5


def test_write_trial_csv_roundtrip(tmp_path):
    data = np.round(np.random.default_rng(1).standard_normal((625, 8)), 7)
    path = tmp_path / "food_test.csv"
    write_trial_csv(path, data)
    text = path.read_text().strip().split("\n")
    assert len(text) == 625 and len(text[0].split(",")) == 8
    np.testing.assert_allclose(np.loadtxt(path, delimiter=","), data, atol=1e-7)


def test_record_trial_bytes_match_jax(tmp_path):
    """The same board samples give a file with the JAX chain's bytes; only
    the uuid in the name differs."""
    board = _FixedBoard(board_windows(1, 3)[0].T * 40.0)
    ours = record_trial(board, "water", tmp_path / "ours", device="cpu")
    theirs = jax_record_trial(board, "water", tmp_path / "jax")
    assert ours.name.startswith("water_") and theirs.name.startswith("water_")
    assert ours.read_bytes() == theirs.read_bytes()
    assert record_trial(_FixedBoard(np.zeros((8, 100))), "food", tmp_path, device="cpu") is None


def test_record_trial_from_board(tmp_path):
    board = SyntheticBoard(speed=64.0)
    board.prepare_session()
    board.start_stream(5000)
    try:
        deadline = time.time() + 10
        while board.get_board_data_count() < 625 and time.time() < deadline:
            time.sleep(0.01)
        path = record_trial(board, "water", tmp_path, device="cpu")
    finally:
        board.stop_stream()
        board.release_session()
    assert path is not None and path.name.startswith("water_")
    ds = load_trials(tmp_path, class_prefixes=("food", "water"))
    assert ds.windows.shape == (1, 625, 8) and ds.labels[0] == 1


def test_record_trial_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        record_trial(_FixedBoard(np.zeros((8, 625))), "food", tmp_path)


# -- the experiment ---------------------------------------------------------------
@pytest.mark.parametrize("seed,n_reps", [(0, 10), (3, 5), (7, 1)])
def test_full_random_order_matches_jax(seed, n_reps):
    cfg = ExperimentConfig(n_reps=n_reps, seed=seed)
    order = full_random_order(cfg)
    assert order == jax_full_random_order(JaxExperimentConfig(n_reps=n_reps, seed=seed))
    assert Counter(order) == {w: n_reps for w in cfg.words}
    if n_reps > 1:
        assert order != full_random_order(ExperimentConfig(n_reps=n_reps, seed=seed + 1))


def _started(board):
    board.prepare_session()
    board.start_stream(20000)
    return board


def test_run_experiment_headless(tmp_path):
    board = _started(SyntheticBoard(speed=256.0))
    seen = []
    try:
        cfg = ExperimentConfig(n_reps=1, warmup_seconds=0.0, seed=0)
        paths = run_experiment(board, tmp_path, cfg, on_trial=lambda i, w, p: seen.append((i, w)), device="cpu")
    finally:
        board.release_session()
    assert len(paths) == 4 and [w for _, w in seen] == full_random_order(cfg)
    ds = load_trials(tmp_path, class_prefixes=("food", "water", "yes", "no"))
    assert ds.windows.shape == (4, 625, 8)
    for tok in paths[0].read_text().split("\n", 1)[0].split(","):
        assert len(tok.split(".")[1]) == 7, tok  # the reference's "%.7f"


def test_experiment_cli_cpu(tmp_path, capsys):
    experiment_main(["--board", "synthetic", "--speed", "512", "--reps", "1", "--out", str(tmp_path),
                     "--device", "cpu"])
    assert "wrote 4 trials" in capsys.readouterr().out
    assert len(list(tmp_path.glob("*.csv"))) == 4


def test_experiment_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiment_main(["--board", "synthetic", "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.csv"))


def test_load_words_csv(tmp_path):
    p = tmp_path / "words.csv"
    p.write_text("words\nwater\nfood\nyes\nno\n")
    assert load_words_csv(p) == ("water", "food", "yes", "no")
    bad = tmp_path / "bad.csv"
    bad.write_text("nope\nx\n")
    with pytest.raises(ValueError, match="words"):
        load_words_csv(bad)


def test_repo_words_csv():
    assert load_words_csv(REPO / "words.csv") == ("water", "food", "yes", "no")


def test_stimulus_presenter_session(tmp_path):
    """The terminal presenter's beep, word and cool-off screens in trial
    order, and every trial written."""
    out = io.StringIO()
    presenter = TerminalPresenter(out=out, listen_keys=False)
    board = _started(SyntheticBoard(speed=256.0))
    try:
        cfg = ExperimentConfig(words=("water", "food"), n_reps=1, seed=1)
        paths = run_experiment(board, tmp_path, cfg, presenter=presenter, device="cpu")
    finally:
        presenter.close()
        board.release_session()
    assert len(paths) == 2
    text = out.getvalue()
    assert "\a" in text and "WATER" in text and "FOOD" in text
    assert "COOL OFF" in text and "(ESC or q to abort)" in text


def test_stimulus_abort_keeps_partial_data(tmp_path):
    presenter = TerminalPresenter(out=io.StringIO(), listen_keys=False)
    board = _started(SyntheticBoard(speed=256.0))
    try:
        cfg = ExperimentConfig(words=("water", "food", "yes"), n_reps=2, seed=0)
        paths = run_experiment(board, tmp_path, cfg, presenter=presenter,
                               on_trial=lambda i, w, p: presenter.request_abort(), device="cpu")
    finally:
        presenter.close()
        board.release_session()
    assert len(paths) == 1 and len(list(tmp_path.glob("*.csv"))) == 1


# -- .psyexp ----------------------------------------------------------------------
REFERENCE_LIKE = """<?xml version="1.0" ?>
<PsychoPy2experiment version="2022.2.4" encoding="utf-8">
  <Routines>
    <Routine name="trial">
      <SoundComponent name="sound_1">
        <Param val="0.5" valType="code" name="stopVal"/>
        <Param val="duration (s)" valType="str" name="stopType"/>
        <Param val="0.0" valType="code" name="startVal"/>
      </SoundComponent>
      <TextComponent name="text">
        <Param val="$words" valType="str" name="text"/>
        <Param val="0.5" valType="code" name="startVal"/>
        <Param val="4" valType="code" name="stopVal"/>
      </TextComponent>
      <TextComponent name="text_2">
        <Param val="COOL OFF" valType="str" name="text"/>
        <Param val="4.5" valType="code" name="startVal"/>
        <Param val="1.5" valType="code" name="stopVal"/>
      </TextComponent>
    </Routine>
  </Routines>
  <Flow>
    <LoopInitiator loopType="TrialHandler" name="trials">
      <Param name="conditions" val="[OrderedDict([('words', 'water')]), OrderedDict([('words', 'food')]), OrderedDict([('words', 'yes')]), OrderedDict([('words', 'no')])]" valType="str"/>
      <Param name="conditionsFile" val="words.csv" valType="file"/>
      <Param name="isTrials" val="True" valType="bool"/>
      <Param name="loopType" val="fullRandom" valType="str"/>
      <Param name="nReps" val="1" valType="num"/>
    </LoopInitiator>
    <Routine name="trial"/>
    <LoopTerminator name="trials"/>
  </Flow>
</PsychoPy2experiment>
"""

CUSTOM = """<?xml version="1.0" ?>
<PsychoPy2experiment version="2025.1.1" encoding="utf-8">
  <Routines>
    <Routine name="trial">
      <SoundComponent name="beep">
        <Param val="0.3" valType="code" name="stopVal"/>
        <Param val="0.0" valType="code" name="startVal"/>
      </SoundComponent>
      <TextComponent name="cue">
        <Param val="$words" valType="str" name="text"/>
        <Param val="0.3" valType="code" name="startVal"/>
        <Param val="2.5" valType="code" name="stopVal"/>
      </TextComponent>
      <TextComponent name="rest">
        <Param val="REST" valType="str" name="text"/>
        <Param val="2.8" valType="code" name="startVal"/>
        <Param val="1.0" valType="code" name="stopVal"/>
      </TextComponent>
    </Routine>
  </Routines>
  <Flow>
    <LoopInitiator loopType="TrialHandler" name="trials">
      <Param name="conditionsFile" val="conds.csv" valType="file"/>
      <Param name="isTrials" val="True" valType="bool"/>
      <Param name="nReps" val="6" valType="num"/>
    </LoopInitiator>
  </Flow>
</PsychoPy2experiment>
"""

SCOPED = """<?xml version="1.0" ?>
<PsychoPy2experiment version="2025.1.1" encoding="utf-8">
  <Routines>
    <Routine name="welcome">
      <SoundComponent name="attention">
        <Param val="1.0" valType="code" name="stopVal"/>
        <Param val="0.0" valType="code" name="startVal"/>
      </SoundComponent>
    </Routine>
    <Routine name="trial">
      <SoundComponent name="beep">
        <Param val="0.4" valType="code" name="stopVal"/>
        <Param val="0.0" valType="code" name="startVal"/>
      </SoundComponent>
      <TextComponent name="cue">
        <Param val="$words" valType="str" name="text"/>
        <Param val="0.4" valType="code" name="startVal"/>
        <Param val="3.0" valType="code" name="stopVal"/>
      </TextComponent>
      <TextComponent name="rest">
        <Param val="REST" valType="str" name="text"/>
        <Param val="3.4" valType="code" name="startVal"/>
        <Param val="1.2" valType="code" name="stopVal"/>
      </TextComponent>
    </Routine>
    <Routine name="feedback">
      <TextComponent name="msg">
        <Param val="$msg" valType="str" name="text"/>
        <Param val="0.0" valType="code" name="startVal"/>
        <Param val="9.0" valType="code" name="stopVal"/>
      </TextComponent>
      <TextComponent name="bye">
        <Param val="BYE" valType="str" name="text"/>
        <Param val="8.0" valType="code" name="startVal"/>
        <Param val="5.0" valType="code" name="stopVal"/>
      </TextComponent>
    </Routine>
  </Routines>
  <Flow>
    <Routine name="welcome"/>
    <LoopInitiator loopType="TrialHandler" name="trials">
      <Param name="isTrials" val="True" valType="bool"/>
      <Param name="nReps" val="4" valType="num"/>
      <Param name="random seed" val="7" valType="code"/>
    </LoopInitiator>
    <Routine name="trial"/>
    <LoopTerminator name="trials"/>
    <Routine name="feedback"/>
  </Flow>
</PsychoPy2experiment>
"""

TIME_STOPS = """<?xml version="1.0" ?>
<PsychoPy2experiment version="2025.1.1" encoding="utf-8">
  <Routines>
    <Routine name="trial">
      <SoundComponent name="beep">
        <Param val="time (s)" valType="str" name="stopType"/>
        <Param val="0.5" valType="code" name="stopVal"/>
        <Param val="0.0" valType="code" name="startVal"/>
      </SoundComponent>
      <TextComponent name="cue">
        <Param val="$words" valType="str" name="text"/>
        <Param val="time (s)" valType="str" name="stopType"/>
        <Param val="0.5" valType="code" name="startVal"/>
        <Param val="4.5" valType="code" name="stopVal"/>
      </TextComponent>
      <TextComponent name="rest">
        <Param val="COOL OFF" valType="str" name="text"/>
        <Param val="time (s)" valType="str" name="stopType"/>
        <Param val="4.5" valType="code" name="startVal"/>
        <Param val="6.0" valType="code" name="stopVal"/>
      </TextComponent>
    </Routine>
  </Routines>
  <Flow>
    <LoopInitiator loopType="TrialHandler" name="trials">
      <Param name="isTrials" val="True" valType="bool"/>
      <Param name="nReps" val="10" valType="num"/>
    </LoopInitiator>
    <Routine name="trial"/>
    <LoopTerminator name="trials"/>
  </Flow>
</PsychoPy2experiment>
"""


def _psyexp(tmp_path, text):
    path = tmp_path / "exp.psyexp"
    path.write_text(text)
    cfg = load_psyexp(path)
    assert cfg == ExperimentConfig(**vars(jax_load_psyexp(path)))  # the JAX parser's reading
    return cfg


def test_psyexp_recovers_reference_schedule(tmp_path):
    """A Builder file shaped like the reference's (beep 0.5 s, word 4 s,
    cool-off 1.5 s, inline conditions, its words.csv absent): the schedule
    and vocabulary come back; nReps is what the XML says."""
    cfg = _psyexp(tmp_path, REFERENCE_LIKE)
    assert (cfg.beep_seconds, cfg.word_seconds, cfg.cooloff_seconds) == (0.5, 4.0, 1.5)
    assert cfg.trial_seconds == 6.0
    assert cfg.words == ("water", "food", "yes", "no")
    assert cfg.n_reps == 1


def test_psyexp_custom_timings(tmp_path):
    (tmp_path / "conds.csv").write_text("words\nleft\nright\n")
    cfg = _psyexp(tmp_path, CUSTOM)
    assert (cfg.beep_seconds, cfg.word_seconds, cfg.cooloff_seconds) == (0.3, 2.5, 1.0)
    assert cfg.words == ("left", "right") and cfg.n_reps == 6


def test_psyexp_scopes_to_trial_routine(tmp_path):
    cfg = _psyexp(tmp_path, SCOPED)
    assert (cfg.beep_seconds, cfg.word_seconds, cfg.cooloff_seconds) == (0.4, 3.0, 1.2)
    assert cfg.n_reps == 4 and cfg.seed == 7


def test_psyexp_stoptype_time_seconds(tmp_path):
    cfg = _psyexp(tmp_path, TIME_STOPS)
    assert (cfg.beep_seconds, cfg.word_seconds, cfg.cooloff_seconds) == (0.5, 4.0, 1.5)
    assert cfg.trial_seconds == 6.0


# -- the browser presenter (test_web_stimulus) ---------------------------------------
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read()


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, r.read()


@pytest.fixture()
def presenter():
    p = WebPresenter(port=0)
    yield p
    p.close()


def test_page_serves(presenter):
    status, body = _get(presenter.port, "/")
    assert status == 200
    assert "AudioContext" in body.decode() and "Escape" in body.decode()


def test_phase_transitions_and_seq(presenter):
    seqs = []
    for call, phase, word in [
        (presenter.beep, "beep", ""),
        (lambda: presenter.show_word("water"), "word", "water"),
        (presenter.cool_off, "cooloff", ""),
    ]:
        call()
        s = json.loads(_get(presenter.port, "/api/stimulus")[1])
        assert s["phase"] == phase and s["word"] == word
        seqs.append(s["seq"])
    assert seqs == sorted(seqs) and len(set(seqs)) == 3


def test_status_line(presenter):
    presenter.status("warming up…")
    assert json.loads(_get(presenter.port, "/api/stimulus")[1])["status"] == "warming up…"


def test_abort_over_http(presenter):
    assert not presenter.aborted()
    assert _post(presenter.port, "/api/abort")[0] == 200
    assert presenter.aborted()


def test_404s(presenter):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(presenter.port, "/nope")
    assert exc.value.code == 404


def test_full_session_with_web_presenter(tmp_path):
    """An abridged session records trials while the web presenter serves
    the protocol (the CLI's --stimulus web path)."""
    p = WebPresenter(port=0)
    board = _started(open_board("synthetic", speed=512.0))
    try:
        cfg = ExperimentConfig(words=("water", "food"), n_reps=1, seed=0, warmup_seconds=0.5)
        paths = run_experiment(board, str(tmp_path), cfg, presenter=p, speed=512.0, device="cpu")
    finally:
        board.release_session()
        p.close()
    assert len(paths) == 2
    for path in paths:
        assert np.loadtxt(path, delimiter=",").shape == (625, 8)
    assert p._state["seq"] >= 6  # 2 trials x 3 phases
