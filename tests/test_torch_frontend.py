"""The port's frontends on the CPU: the shared helpers (mock draws equal to
the JAX package's for a seed), `decode_snapshot`, the stdlib dashboard
(/api/decode and /api/stream bodies against the JAX dashboard's for the
same board and model: the same fields, <= 1e-5 |delta prob|), its engine
cache, and the Streamlit page under a fake streamlit module.
"""

import json
import os
import runpy
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from jax import random as jax_random

import neural_speech_decoding_tpu.frontend.server as jax_server
import neural_speech_decoding_tpu.runtime.board as jax_board_mod
from neural_speech_decoding_tpu.frontend import common as jax_common
from neural_speech_decoding_tpu.io.params_io import save_params_npz as jax_save_npz
from neural_speech_decoding_tpu.models.registry import get_model as jax_get_model
from neural_speech_decoding_tpu.runtime.engine import InferenceEngine as JaxEngine
from neural_speech_decoding_tpu_torch.frontend import common
from neural_speech_decoding_tpu_torch.frontend import server as srv
from neural_speech_decoding_tpu_torch.runtime import board as board_mod
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

REPO = Path(__file__).resolve().parents[1]
APP = REPO / "neural_speech_decoding_tpu_torch" / "frontend" / "app.py"
PROB_TOL = 1e-5
SMALL_LSTM = {"hidden_size": 8}
CLASSES = ("Food", "Water", "None")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class StaticBoard(board_mod.Board):
    """Every read returns the same window, its counter a window further on
    each time: any two frontends that read it decode the same samples."""

    def __init__(self, window_tc, speed: float = 256.0):
        super().__init__(8, 125, speed=speed)
        self._window = np.ascontiguousarray(np.asarray(window_tc, np.float64).T)  # [C, T]
        self._reads = 0

    def start_stream(self, buffer_size: int = 450000) -> None:
        if not self._prepared:
            raise RuntimeError("prepare_session() not called")
        self._streaming = True

    def stop_stream(self) -> None:
        self._streaming = False

    def get_board_data_count(self) -> int:
        return self._window.shape[1]

    def get_current_board_data(self, n: int) -> np.ndarray:
        self._reads += 1
        out = np.empty((self.num_rows, n))
        out[0] = self._reads * n + np.arange(n)
        out[1:] = self._window[:, -n:]
        return out


def board_window(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(625) / 125.0
    ch = np.arange(8)
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + rng.uniform(0, 2 * np.pi, 8))
    return (x + 0.35 * rng.standard_normal((625, 8))).astype(np.float32)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """A small LSTM (hidden 8) from the JAX registry's init, in both engines."""
    path = tmp_path_factory.mktemp("frontend") / "lstm_small.npz"
    jax_save_npz(path, jax_get_model("lstm", **SMALL_LSTM).init(jax_random.PRNGKey(3)))
    return (InferenceEngine(str(path), model_kw=SMALL_LSTM, class_names=CLASSES, device="cpu"),
            JaxEngine(str(path), model_kw=SMALL_LSTM, class_names=CLASSES))


@pytest.fixture
def static_boards(monkeypatch):
    """open_board in both packages returns a StaticBoard of one window."""
    window = board_window(0)
    make = lambda spec, num_channels=8, speed=1.0: StaticBoard(window, speed=256.0)  # noqa: E731
    monkeypatch.setattr(board_mod, "open_board", make)
    monkeypatch.setattr(jax_board_mod, "open_board", make)
    return window


# -- shared helpers (test_frontend) -------------------------------------------------
def test_mock_probs_contract_and_jax_draws():
    probs = common.generate_mock_probs("Water", np.random.default_rng(0))
    assert set(probs) == set(common.CLASSES)
    assert 0.60 <= probs["Water"] <= 0.70
    assert abs(sum(probs.values()) - 1.0) < 1e-9
    assert probs == jax_common.generate_mock_probs("Water", np.random.default_rng(0))


def test_mock_eeg_shape_and_jax_draws():
    eeg = common.generate_mock_eeg(np.random.default_rng(0))
    assert eeg.shape == (common.SAMPLES, common.CHANNELS) and np.isfinite(eeg).all()
    np.testing.assert_array_equal(eeg, jax_common.generate_mock_eeg(np.random.default_rng(0)))


def test_normalize_eeg_zscore():
    chunk = np.random.default_rng(1).standard_normal((625, 8)) * 5 + 3
    out = common.normalize_eeg(chunk)
    np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-9)
    np.testing.assert_allclose(out.std(axis=0), 1.0, atol=1e-3)
    np.testing.assert_array_equal(out, jax_common.normalize_eeg(chunk))


def test_mock_snapshot_roundtrip():
    d = common.mock_snapshot("Food", seed=0).to_json_dict()
    assert json.dumps(d)
    assert d["transcript"].startswith("Predicted:") and len(d["eeg"]) == common.SAMPLES
    theirs = jax_common.mock_snapshot("Food", seed=0).to_json_dict()
    assert {k: v for k, v in d.items() if k != "timestamp"} == {k: v for k, v in theirs.items() if k != "timestamp"}


def _same_snapshot(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    assert set(ours["word_probs"]) == set(theirs["word_probs"])
    for k, v in ours["word_probs"].items():
        assert abs(v - theirs["word_probs"][k]) <= PROB_TOL
    assert ours["transcript"] == theirs["transcript"] and ours["status"] == theirs["status"]
    np.testing.assert_allclose(np.asarray(ours["eeg"]), np.asarray(theirs["eeg"]), rtol=0, atol=1e-6)


def test_decode_snapshot_matches_jax(engines, static_boards):
    engine, jax_engine = engines
    ours = common.decode_snapshot("static", speed=256.0, trials=2, engine=engine)
    theirs = jax_common.decode_snapshot("static", speed=256.0, trials=2, engine=jax_engine)
    _same_snapshot(ours.to_json_dict(), theirs.to_json_dict())
    assert ours.status == "Device snapshot ready." and "windows/s" in ours.stats_line


# -- the dashboard ---------------------------------------------------------------------
def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def dashboard():
    server = srv.make_server(0, warm_family=None, device="cpu")
    t = _serve(server)
    yield server, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    t.join(timeout=5)
    assert not t.is_alive()


@pytest.fixture
def jax_dashboard(monkeypatch):
    monkeypatch.setattr(jax_server, "STATE", jax_server._State())
    server = ThreadingHTTPServer(("127.0.0.1", 0), jax_server.Handler)
    t = _serve(server)
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    t.join(timeout=5)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_dashboard_page(dashboard):
    status, body = _get(dashboard[1] + "/")
    assert status == 200 and b"Imagined-Speech Decoding" in body


def test_dashboard_state(dashboard):
    status, body = _get(dashboard[1] + "/api/state")
    assert status == 200 and "word_probs" in json.loads(body)


def test_dashboard_mock_decode(dashboard):
    status, snap = _post(dashboard[1] + "/api/decode", {"mode": "mock", "focus": "Water"})
    assert status == 200
    assert snap["word_probs"]["Water"] >= 0.60 and snap["transcript"].startswith("Predicted:")


def test_dashboard_bad_request(dashboard):
    """An unadapted port: 500 naming the serial port (the default engine,
    the port's shipped checkpoint, builds on the CPU first)."""
    status, snap = _post(dashboard[1] + "/api/decode", {"mode": "device", "board": "/dev/bogus", "trials": 1})
    assert status == 500
    assert "serial port" in snap["error"]


def test_dashboard_404(dashboard):
    with pytest.raises(urllib.error.HTTPError):
        _get(dashboard[1] + "/api/nope")


def test_dashboard_stream_error(dashboard):
    status, body = _post(dashboard[1] + "/api/stream", {"board": "/dev/nope", "predictions": 1})
    assert status == 500 and "error" in body


def test_dashboard_decode_and_stream_match_jax(dashboard, jax_dashboard, engines, static_boards):
    """/api/decode (device mode) and /api/stream on the same board and
    model: the JAX dashboard's fields, probabilities within 1e-5."""
    server, url = dashboard
    engine, jax_engine = engines
    server.state.engines[("lstm", None, None)] = engine
    jax_server.STATE.engines[("lstm", None, None)] = jax_engine
    req = {"mode": "device", "board": "static", "trials": 2, "speed": 256}
    s1, ours = _post(url + "/api/decode", req)
    s2, theirs = _post(jax_dashboard + "/api/decode", req)
    assert s1 == s2 == 200
    _same_snapshot(ours, theirs)

    req = {"board": "static", "predictions": 3, "hop_seconds": 1.0, "average_n": 2, "timeout": 10}
    s1, ours = _post(url + "/api/stream", req)
    s2, theirs = _post(jax_dashboard + "/api/stream", req)
    assert s1 == s2 == 200
    assert set(ours) == set(theirs)
    assert len(ours["predictions"]) == len(theirs["predictions"]) == 3
    for p, q in zip(ours["predictions"], theirs["predictions"]):
        assert set(p) == set(q) and p["index"] == q["index"] and p["label"] == q["label"]
        assert np.abs(np.subtract(p["probs"], q["probs"])).max() <= PROB_TOL
        assert np.abs(np.subtract(p["avg_probs"], q["avg_probs"])).max() <= PROB_TOL
    assert ours["guard_flagged"] == theirs["guard_flagged"] == 0
    assert ours["latency_p50_ms"] > 0


def test_dashboard_concurrent_decodes_keep_counts(dashboard, engines, static_boards):
    """Two /api/decode posts at once on one engine: both answer, and the
    engine's stats lock counts every window."""
    server, url = dashboard
    engine, _ = engines
    server.state.engines[("lstm", None, None)] = engine
    before = engine.stats["windows"]
    results = []
    req = {"mode": "device", "board": "static", "trials": 2, "speed": 256}
    threads = [threading.Thread(target=lambda: results.append(_post(url + "/api/decode", req))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert [s for s, _ in results] == [200, 200]
    assert engine.stats["windows"] - before == 4


def test_server_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.make_server(0, warm_family=None)


def _logcov_members(tmp_path, n):
    spec = jax_get_model("logcov")
    paths = []
    for s in range(n):
        p = tmp_path / f"m{s}.npz"
        jax_save_npz(p, spec.init(jax_random.PRNGKey(s)))
        paths.append(str(p))
    return paths


def test_server_resolves_manifest_engine(tmp_path):
    """A fit_ensemble manifest path serves through EnsembleEngine on the
    server's device, cached by path; a failed build caches nothing."""
    manifest = tmp_path / "x_manifest.json"
    manifest.write_text(json.dumps({"model": "logcov", "members": _logcov_members(tmp_path, 2)}))
    state = srv.DashboardState(torch.device("cpu"))
    eng = srv._resolve_engine(state, "logcov", str(manifest))
    assert isinstance(eng, EnsembleEngine) and eng.device == torch.device("cpu")
    assert srv._resolve_engine(state, "logcov", str(manifest)) is eng
    with pytest.raises(FileNotFoundError):
        srv._resolve_engine(state, "eegnet", str(tmp_path / "missing.npz"))
    assert not any(k[0] == "eegnet" for k in state.engines)


def test_server_engine_cache_validation_and_invalidation(tmp_path):
    """A wrong-family manifest request errors; a rewritten checkpoint (new
    mtime) rebuilds; the cache stays bounded."""
    manifest = tmp_path / "y_manifest.json"
    manifest.write_text(json.dumps({"model": "logcov", "members": _logcov_members(tmp_path, 1)}))
    state = srv.DashboardState(torch.device("cpu"))
    with pytest.raises(ValueError, match="serves model"):
        srv._resolve_engine(state, "tcn", str(manifest))
    eng1 = srv._resolve_engine(state, "logcov", str(manifest))
    assert srv._resolve_engine(state, "logcov", str(manifest)) is eng1
    os.utime(manifest, (time.time() + 5, time.time() + 5))
    eng2 = srv._resolve_engine(state, "logcov", str(manifest))
    assert eng2 is not eng1
    assert len(state.engines) <= srv._ENGINE_CACHE_MAX


# -- the Streamlit page (test_streamlit_app) ----------------------------------------------
class SessionState(types.SimpleNamespace):
    def __contains__(self, key):
        return key in self.__dict__


class FakeStreamlit:
    """The API surface app.py uses; buttons are scripted."""

    def __init__(self):
        self.session_state = SessionState()
        self.pressed = set()
        self.markdowns, self.writes, self.infos, self.errors = [], [], [], []

    def set_page_config(self, **kw):
        pass

    def title(self, *a):
        pass

    def header(self, *a):
        pass

    def subheader(self, *a):
        pass

    def caption(self, *a):
        pass

    def markdown(self, text):
        self.markdowns.append(text)

    def write(self, text):
        self.writes.append(text)

    def info(self, text, **kw):
        self.infos.append(text)

    def error(self, text, **kw):
        self.errors.append(text)

    def success(self, text):
        pass

    def metric(self, *a, **kw):
        pass

    def line_chart(self, *a, **kw):
        pass

    def columns(self, spec):
        return [self] * (spec if isinstance(spec, int) else len(spec))

    def expander(self, *a, **kw):
        return self

    def empty(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def checkbox(self, label, value=False, **kw):
        return value

    def text_input(self, label, value="", **kw):
        return value

    def slider(self, label, lo, hi, default, **kw):
        return default

    def number_input(self, label, lo, hi, default, **kw):
        return default

    def selectbox(self, label, options, **kw):
        return options[0]

    def button(self, label, disabled=False, **kw):
        return (label in self.pressed) and not disabled

    @property
    def sidebar(self):
        return self


@pytest.fixture()
def fake_st(monkeypatch):
    fake = FakeStreamlit()
    mod = types.ModuleType("streamlit")
    mod.__dict__.update({n: getattr(fake, n) for n in dir(fake) if not n.startswith("_") and n != "sidebar"})
    mod.sidebar = fake
    mod.session_state = fake.session_state
    monkeypatch.setitem(sys.modules, "streamlit", mod)
    return fake


def _run_app():
    return runpy.run_path(str(APP), run_name="app")


def test_streamlit_app_compiles():
    import py_compile

    py_compile.compile(str(APP), doraise=True)


def test_streamlit_missing_is_actionable(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)  # import fails
    with pytest.raises(ImportError, match="frontend.server"):
        _run_app()


def test_initial_render_no_badge(fake_st):
    _run_app()
    state = fake_st.session_state.nsd_state
    assert state.running is False and state.transcript == []
    assert not any("Recording" in m for m in fake_st.markdowns)
    assert "Press Start to begin." in fake_st.writes


def test_start_raises_badge_and_appends_transcript(fake_st):
    fake_st.pressed = {"Start"}
    _run_app()
    state = fake_st.session_state.nsd_state
    assert state.running is True
    assert len(state.transcript) == 1 and state.transcript[0].startswith("Predicted:")
    assert any("Recording" in m for m in fake_st.markdowns)


def test_stop_recaptures_then_lowers_badge(fake_st):
    fake_st.pressed = {"Start"}
    _run_app()
    fake_st.pressed = {"Stop", "Start"}  # Start is disabled while running
    fake_st.markdowns = []
    _run_app()
    assert fake_st.session_state.nsd_state.running is False
    assert len(fake_st.session_state.nsd_state.transcript) == 2
    fake_st.pressed = set()
    fake_st.markdowns = []
    _run_app()
    assert not any("Recording" in m for m in fake_st.markdowns)
    assert len(fake_st.session_state.nsd_state.transcript) == 2
