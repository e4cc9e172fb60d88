"""The port's analysis modules held against the JAX package's (x64 on):
intake (CSV and a small EDF written here), the metrics, `analyze_file` on
a CSV and an EDF (filtered output and every metric within 1e-9 of the
largest |value|; the written CSV and JSON with the same names and
fields), `run_realtime` (each window's metrics within 1e-9 of JAX's
`mai_filter` and `compute_filter_metrics` on the window at the same board
counter), the CLIs with --device cpu, and the refusal without CUDA.
Inputs are made with numpy from a seed.
"""

import json
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.analysis import io as jax_io
from neural_speech_decoding_tpu.analysis import metrics as jax_metrics
from neural_speech_decoding_tpu.analysis.offline import analyze_file as jax_analyze_file
from neural_speech_decoding_tpu.analysis.realtime import run_realtime as jax_run_realtime
from neural_speech_decoding_tpu.config import FilterConfig as JaxFilterConfig
from neural_speech_decoding_tpu.ops.kuramoto import mai_filter as jax_mai_filter
from neural_speech_decoding_tpu.train.augment import inject_noise_np as jax_inject_noise_np
from neural_speech_decoding_tpu_torch import analysis
from neural_speech_decoding_tpu_torch.analysis import io, metrics, offline, realtime
from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard

REL_TOL = 1e-9
C = 8


def close(got, want, tol=REL_TOL):
    """Every number of two nested dicts/lists within tol of the largest
    |value| of its leaf (exact for strings, bools and None)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        return all(close(got[k], want[k], tol) for k in want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        return all(close(g, w, tol) for g, w in zip(got, want))
    if isinstance(want, (bool, str)) or want is None:
        assert got == want, (got, want)
        return True
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, (err, got, want)
    return True


def recording_ct(t: int, seed: int, scale: float = 30.0, offset: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = np.arange(t) / 125.0
    x = np.sin(2 * np.pi * (8 + np.arange(C))[:, None] * ts + rng.uniform(0, 2 * np.pi, (C, 1)))
    x = x + 0.4 * np.sin(2 * np.pi * 2.0 * ts + np.arange(C)[:, None])
    x = x + 0.35 * rng.standard_normal((C, t))
    x[2, t // 3 : t // 3 + 40] += 12.0  # an artifact burst
    return scale * x + offset


def write_edf(path, data_ct: np.ndarray, fs: int, record_seconds: float = 1.0, annotations: bool = True):
    """A small EDF+ file written field by field: int16 samples of the
    physical range +-500 uV, one record a second, plus an annotation
    channel when asked."""
    per = int(fs * record_seconds)
    n_rec = data_ct.shape[1] // per
    labels = [f"EEG C{i}" for i in range(data_ct.shape[0])] + (["EDF Annotations"] if annotations else [])
    ns = len(labels)
    spr = [per] * data_ct.shape[0] + ([16] if annotations else [])

    def fld(values, width):
        return b"".join(str(v).ljust(width)[:width].encode("ascii") for v in values)

    header = (
        "0".ljust(8) + "X X X X".ljust(80) + "Startdate 01-JAN-2026 X X X".ljust(80)
        + "01.01.26" + "00.00.00" + str(256 * (ns + 1)).ljust(8) + "EDF+C".ljust(44)
        + str(n_rec).ljust(8) + str(record_seconds).ljust(8) + str(ns).ljust(4)
    ).encode("ascii")
    header += fld(labels, 16) + fld([""] * ns, 80) + fld(["uV"] * ns, 8)
    header += fld([-500] * ns, 8) + fld([500] * ns, 8) + fld([-32768] * ns, 8) + fld([32767] * ns, 8)
    header += fld([""] * ns, 80) + fld(spr, 8) + fld([""] * ns, 32)
    gain = 1000.0 / 65535.0
    dig = np.clip(np.round((data_ct + 500.0) / gain - 32768), -32768, 32767).astype("<i2")
    body = bytearray()
    for r in range(n_rec):
        for ch in range(data_ct.shape[0]):
            body += dig[ch, r * per : (r + 1) * per].tobytes()
        if annotations:
            body += struct.pack("<16h", *([0] * 16))
    path.write_bytes(header + bytes(body))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analysis")
    csv = d / "board.csv"  # a board-like [T, C] export in volts, with a header and an index column
    x = recording_ct(60 * 125, seed=1) * 1e-6
    rows = "\n".join(f"{i}," + ",".join(f"{v:.12e}" for v in x[:, i]) for i in range(x.shape[1]))
    csv.write_text("index," + ",".join(f"ch{i}" for i in range(C)) + "\n" + rows + "\n")
    edf = d / "small.edf"
    write_edf(edf, recording_ct(250 * 12, seed=2, scale=40.0, offset=3.0), fs=250)
    return {"csv": csv, "edf": edf}


def test_intake_matches_jax(files, tmp_path):
    arr = io.read_numeric_csv(files["csv"])
    np.testing.assert_array_equal(arr, jax_io.read_numeric_csv(files["csv"]))
    assert arr.shape == (60 * 125, C)  # header and index column dropped
    np.testing.assert_array_equal(io.detect_orientation(arr), jax_io.detect_orientation(arr))
    assert io.detect_orientation(arr).shape == (C, 60 * 125)
    for scale in (1e-6, 1e-3, 1.0, 1e3, 0.0):
        assert io.detect_unit_scale(arr * scale) == jax_io.detect_unit_scale(arr * scale)
    sig, fs = io.read_edf_numeric(files["edf"])
    jsig, jfs = jax_io.read_edf_numeric(files["edf"])
    np.testing.assert_array_equal(sig, jsig)
    assert fs == jfs == 250.0 and sig.shape == (C, 3000)  # the annotation channel skipped
    hdr, jhdr = io.EdfHeader(files["edf"].read_bytes()), jax_io.EdfHeader(files["edf"].read_bytes())
    assert vars(hdr) == vars(jhdr)
    # truncated and junk files are refused the same way
    bad = tmp_path / "junk.edf"
    bad.write_bytes(b"not an edf")
    for reader in (io.read_edf_numeric, jax_io.read_edf_numeric):
        with pytest.raises(ValueError):
            reader(bad)
    (tmp_path / "t.txt").write_text("a b\nc d\n")
    for reader in (io.read_numeric_csv, jax_io.read_numeric_csv):
        with pytest.raises(ValueError, match="no numeric rows"):
            reader(tmp_path / "t.txt")


@pytest.mark.parametrize("method", metrics.SNR_METHODS)
def test_metrics_match_jax(method, tmp_path):
    raw = recording_ct(625, seed=3)
    filt = 0.4 * raw + 0.01 * recording_ct(625, seed=4)
    for ch in (0, 5):
        m = metrics.compute_filter_metrics(raw, filt, fs=125.0, channel=ch, method=method, lambd=1e-30)
        want = jax_metrics.compute_filter_metrics(raw, filt, fs=125.0, channel=ch, method=method, lambd=1e-30)
        assert m == want
        assert metrics.format_metrics(m) == jax_metrics.format_metrics(want)
    assert metrics.snr_db(raw[0], np.zeros(625), method) == float("inf")
    m = metrics.compute_filter_metrics(raw, raw, fs=125.0)
    assert m["snr_db_channel"] is None and metrics.format_metrics(m) == jax_metrics.format_metrics(m)
    metrics.save_metrics_json(tmp_path / "a" / "m.json", want)
    assert json.loads((tmp_path / "a" / "m.json").read_text()) == want
    with pytest.raises(ValueError, match="unknown SNR method"):
        metrics.snr_db(raw[0], raw[1], "nope")
    assert analysis.snr_db is metrics.snr_db and analysis.read_numeric_csv is io.read_numeric_csv


def _stripped(path):
    """A written file's name without its time stamp."""
    return re.sub(r"_\d{8}T\d{6}", "_<stamp>", path.name)


@pytest.mark.parametrize("kind, lambd, channel", [("csv", 1e-25, 0), ("csv", 1e-34, 3), ("edf", 1e-29, 2)])
def test_analyze_file_matches_jax(files, tmp_path, kind, lambd, channel):
    ours_dir, theirs_dir = tmp_path / "port", tmp_path / "jax"
    m, filt = offline.analyze_file(files[kind], lambd=lambd, channel=channel, out_dir=ours_dir, device="cpu")
    jm, jfilt = jax_analyze_file(files[kind], lambd=lambd, channel=channel, out_dir=theirs_dir)
    assert filt.dtype == np.float64 and filt.shape == jfilt.shape
    assert float(np.abs(filt - jfilt).max() / np.abs(jfilt).max()) <= REL_TOL
    close(m, jm)
    assert m["detected_unit"] == ("volts" if kind == "csv" else "microvolts")
    assert m["fs_hz"] == (125.0 if kind == "csv" else 250.0)
    ours = sorted(ours_dir.iterdir())
    theirs = sorted(theirs_dir.iterdir())
    assert [_stripped(p) for p in ours] == [_stripped(p) for p in theirs] and len(ours) == 2
    for p, q in zip(ours, theirs):
        if p.suffix == ".json":
            close(json.loads(p.read_text()), json.loads(q.read_text()))
        else:
            got, want = np.loadtxt(p, delimiter=","), np.loadtxt(q, delimiter=",")
            assert got.shape == want.shape and float(np.abs(got - want).max()) <= 2e-7


class RecordedBoard:
    """Serves a fixed list of board reads in order (the windows another run
    saw), with the board surface run_realtime uses."""

    def __init__(self, reads, speed=16.0):
        self.reads = list(reads)
        self.eeg_channels = list(range(1, C + 1))
        self.speed = speed
        self._next = 0

    def get_board_id(self):
        return -1

    def get_sampling_rate(self, board_id=-1):
        return 125

    def get_board_data_count(self):
        return 10**9

    def get_current_board_data(self, n):
        data = self.reads[min(self._next, len(self.reads) - 1)]
        self._next += 1
        return data


class RecordingBoard(SyntheticBoard):
    """A SyntheticBoard that keeps every read of run_realtime."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.reads = []

    def get_current_board_data(self, n):
        data = super().get_current_board_data(n)
        self.reads.append(data)
        return data


@pytest.mark.parametrize("inject", ["burst", "", "sine"])
def test_run_realtime_matches_jax(inject):
    board = RecordingBoard(speed=32.0)
    board.prepare_session()
    board.start_stream(5000)
    seen = []
    try:
        got = realtime.run_realtime(board, n_windows=4, window_seconds=1.0, lambd=1e-25, inject=inject,
                                    seed=5, on_window=lambda i, m: seen.append(i), timeout=60, device="cpu")
    finally:
        board.release_session()
    assert len(got) == 4 and seen == [0, 1, 2, 3]
    windows = []  # the reads that were analysed, by their counters
    last = -1
    for data in board.reads:
        if data.shape[1] == 125 and int(data[0, -1]) != last:
            windows.append(data)
            last = int(data[0, -1])
    assert len(windows) == 4
    # JAX's run_realtime over the same reads, and JAX's filter and metrics
    # on each window at its counter, with the same noise draws
    theirs = jax_run_realtime(RecordedBoard(windows), n_windows=4, window_seconds=1.0, lambd=1e-25,
                              inject=inject, seed=5, timeout=60)
    close(got, theirs)
    rng = np.random.default_rng(5)
    cfg = JaxFilterConfig(lambd=1e-25)
    for m, data in zip(got, windows):
        eeg = data[1:].T.astype(np.float64)
        if inject:
            eeg = jax_inject_noise_np(eeg, inject, rng, strength=2.0)
        raw = eeg - eeg.mean(axis=0, keepdims=True)
        filt = np.asarray(jax_mai_filter(jnp.asarray(raw.astype(np.float32)), cfg)).astype(np.float64)
        close(m, jax_metrics.compute_filter_metrics(raw.T, filt.T, fs=125, channel=0, lambd=1e-25))
        assert m["duration_sec"] == 1.0


def test_offline_cli(files, tmp_path, capsys):
    offline.main([str(files["edf"]), "--lambda", "1e-30", "--channel", "1", "--out-dir", str(tmp_path),
                  "--device", "cpu"])
    assert capsys.readouterr().out.startswith("[SNR")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and names[0].startswith("small_mai_filtered_1e-30_")
    assert names[1].startswith("small_mai_metrics_1e-30_")


def test_realtime_cli(capsys):
    realtime.main(["--board", "synthetic", "--speed", "64", "--windows", "2", "--inject", "white",
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("win 000 [SNR") and lines[1].startswith("win 001")


def test_without_cuda_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline.analyze_file(files["csv"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        realtime.run_realtime(RecordedBoard([]), n_windows=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline.main([str(files["csv"])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        realtime.main(["--windows", "1"])
