"""Dependency-free web dashboard (stdlib http.server).

Counterpart of neural_speech_decoding_tpu/frontend/server.py: the same
page and endpoints, served by the port. Mock mode, device snapshots
through the streaming runtime, probability cards, the z-scored 8-channel
chart, transcript and runtime stats:

  python -m neural_speech_decoding_tpu_torch.frontend.server --port 8777 [--device cpu]

Endpoints:
  GET  /            the dashboard page
  GET  /api/state   last snapshot as JSON
  POST /api/decode  {"mode": "mock"|"device", "board": ..., "speed": ...,
                     "trials": ..., "family": ..., "model_path": ...}
  POST /api/stream  {"board": ..., "speed": ..., "predictions": ...,
                     "hop_seconds": ..., "average_n": ..., "family": ...,
                     "model_path": ...}
                    -> continuous sliding-window decode (runtime/stream.py)

Each server owns its state (`DashboardState`: the last snapshot, the
engine cache, the device every engine is built on). Requests are served
from handler threads; engines are built under one build lock, each on the
server's device, and the engines' stats lock holds their counts under
concurrent requests. The default model is the repository's
checkpoints/lstm3_retrained.npz (or $NSD_MODEL).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import torch

from neural_speech_decoding_tpu_torch.frontend import common
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>EEG Decoding (PyTorch port)</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#eee; margin:2rem; }
 .cards { display:flex; gap:1rem; margin:1rem 0; }
 .card { background:#1c1c24; border:1px solid #333; border-radius:12px; padding:1rem 1.5rem; min-width:10rem; }
 .label { color:#9ca3af; font-size:.8rem; }
 .value { font-size:1.8rem; font-weight:700; }
 button { background:#4f46e5; color:white; border:0; border-radius:8px; padding:.6rem 1.4rem; font-size:1rem; cursor:pointer; }
 select,input { background:#222; color:#eee; border:1px solid #444; border-radius:6px; padding:.3rem; }
 #status { color:#9ca3af; margin:.5rem 0; }
 svg { background:#1c1c24; border:1px solid #333; border-radius:12px; }
</style></head>
<body>
<h2>Imagined-Speech Decoding — PyTorch backend</h2>
<div>
 mode <select id="mode"><option value="mock">mock</option><option value="device">device</option></select>
 board <input id="board" value="replay" size="12">
 speed <input id="speed" value="32" size="4">
 trials <input id="trials" value="10" size="4">
 family <select id="family"><option>lstm</option><option>eegnet</option><option>transformer</option></select>
 <button onclick="decode()">Start</button>
</div>
<div id="status">Press Start to begin.</div>
<div class="cards" id="cards"></div>
<div><svg id="chart" width="900" height="300"></svg></div>
<div id="transcript"></div>
<script>
async function decode() {
  document.getElementById('status').textContent = 'Recording…';
  const body = {
    mode: document.getElementById('mode').value,
    board: document.getElementById('board').value,
    speed: parseFloat(document.getElementById('speed').value),
    trials: parseInt(document.getElementById('trials').value),
    family: document.getElementById('family').value,
  };
  const r = await fetch('/api/decode', {method:'POST', headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  render(await r.json());
}
function render(s) {
  document.getElementById('status').textContent = s.status + (s.stats_line ? ' — ' + s.stats_line : '');
  const cards = document.getElementById('cards');
  cards.innerHTML = '';
  for (const [label, p] of Object.entries(s.word_probs)) {
    cards.innerHTML += `<div class="card"><div class="label">${label}</div><div class="value">${(100*p).toFixed(2)}%</div></div>`;
  }
  document.getElementById('transcript').textContent = s.transcript;
  const svg = document.getElementById('chart');
  svg.innerHTML = '';
  if (!s.eeg) return;
  const T = s.eeg.length, C = s.eeg[0].length, W = 900, H = 300;
  for (let c = 0; c < C; c++) {
    let d = '';
    for (let t = 0; t < T; t++) {
      const x = t / (T - 1) * W;
      const y = H/2 - (s.eeg[t][c] + (c - C/2) * 4) * H / (C * 5);
      d += (t ? 'L' : 'M') + x.toFixed(1) + ',' + y.toFixed(1);
    }
    const hue = c * 45;
    svg.innerHTML += `<path d="${d}" fill="none" stroke="hsl(${hue},70%,60%)" stroke-width="1"/>`;
  }
}
fetch('/api/state').then(r => r.json()).then(render);
</script>
</body></html>
"""


_ENGINE_CACHE_MAX = 8


class DashboardState:
    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()  # snapshot + engine-dict access
        self.build_lock = threading.Lock()  # serializes engine builds
        self.snapshot = common.Snapshot(status="Press Start to begin.")
        self.engines = {}  # (family, path, mtime) -> warmed engine


def _resolve_engine(state: DashboardState, family: str, model_path):
    """Cached engine lookup, keyed by (family, checkpoint path, file
    mtime). The mtime key invalidates stale entries when a checkpoint is
    refit at the same path; the cache is LRU-bounded; a manifest request
    must name the manifest's own family, so a wrong-family request errors
    instead of serving (and caching) the wrong ensemble. Builds happen
    under the build lock (concurrent first requests wait for one build
    instead of duplicating it); the snapshot lock is never held across a
    build, and a failed build caches nothing."""
    path = str(model_path) if model_path else None
    mtime = None
    if path:
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            pass  # a missing file surfaces as the engine's own error below
    key = (family, path, mtime)
    with state.lock:
        engine = state.engines.get(key)
        if engine is not None:
            state.engines[key] = state.engines.pop(key)  # LRU touch
            return engine
    with state.build_lock:
        with state.lock:  # lost the race to another builder?
            engine = state.engines.get(key)
            if engine is not None:
                return engine
        if path and path.endswith(".json"):
            from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

            manifest_model = json.loads(Path(path).read_text()).get("model", "lstm")
            if family and family != manifest_model:
                raise ValueError(
                    f"requested family {family!r} but manifest {path} "
                    f"serves model {manifest_model!r}"
                )
            engine = EnsembleEngine.from_manifest(path, device=state.device)
        else:
            from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
            from neural_speech_decoding_tpu_torch.runtime.tester import default_model_path

            engine = InferenceEngine(
                path or default_model_path(),
                model=family,
                class_names=("Food", "Water", "None") if family == "lstm" else None,
                device=state.device,
            )
        with state.lock:
            state.engines[key] = engine
            while len(state.engines) > _ENGINE_CACHE_MAX:
                state.engines.pop(next(iter(state.engines)))
    return engine


class Handler(BaseHTTPRequestHandler):
    @property
    def state(self) -> DashboardState:
        return self.server.state

    def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass

    def _request(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/state":
            with self.state.lock:
                body = json.dumps(self.state.snapshot.to_json_dict()).encode()
            self._send(200, body)
        else:
            self._send(404, b'{"error": "not found"}')

    def do_POST(self):
        if self.path == "/api/stream":
            self._handle_stream()
            return
        if self.path != "/api/decode":
            self._send(404, b'{"error": "not found"}')
            return
        try:
            req = self._request()
            if req.get("mode", "mock") == "mock":
                snap = common.mock_snapshot(req.get("focus", common.CLASSES[0]))
            else:
                family = req.get("family", "lstm")
                engine = _resolve_engine(self.state, family, req.get("model_path") or None)
                snap = common.decode_snapshot(
                    board_spec=req.get("board", "replay"),
                    speed=float(req.get("speed", 32.0)),
                    trials=int(req.get("trials", 10)),
                    family=family,
                    engine=engine,
                )
            with self.state.lock:
                self.state.snapshot = snap
            self._send(200, json.dumps(snap.to_json_dict()).encode())
        except Exception as exc:  # the boundary: report the failure to the page
            self._send(500, json.dumps({"error": str(exc), "status": f"failed: {exc}",
                                        "word_probs": {}, "eeg": None,
                                        "transcript": "", "stats_line": "",
                                        "timestamp": ""}).encode())

    def _handle_stream(self):
        try:
            req = self._request()
            engine = _resolve_engine(self.state, req.get("family", "lstm"), req.get("model_path") or None)

            from neural_speech_decoding_tpu_torch.runtime.board import open_board
            from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder

            board = open_board(req.get("board", "replay"), speed=float(req.get("speed", 32.0)))
            dec = StreamDecoder(
                engine,
                board,
                window_seconds=float(req.get("window_seconds", 5.0)),
                hop_seconds=float(req.get("hop_seconds", 1.0)),
                average_n=int(req.get("average_n", 10)),
            )
            preds, stats = dec.run(int(req.get("predictions", 10)),
                                   timeout=float(req.get("timeout", 120.0)))
            body = {
                "predictions": [
                    {
                        "index": p.index,
                        "label": p.label,
                        "probs": p.probs.tolist(),
                        "avg_probs": p.avg_probs.tolist(),
                        "latency_ms": (p.t_ready - p.t_window) * 1e3,
                    }
                    for p in preds
                ],
                "windows_per_second": stats.windows_per_second,
                "latency_p50_ms": stats.latency.percentile(50) * 1e3,
                "latency_p90_ms": stats.latency.percentile(90) * 1e3,
                # windows the logcov spectrum guard clamped, over the
                # engine's life: reported to the page, not silently decoded
                "guard_flagged": engine.stats["guard_flagged"],
            }
            self._send(200, json.dumps(body).encode())
        except Exception as exc:  # the boundary: report the failure to the page
            self._send(500, json.dumps({"error": str(exc)}).encode())


class DashboardServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the dashboard's state."""

    def __init__(self, address, state: DashboardState):
        self.state = state
        super().__init__(address, Handler)


def make_server(
    port: int = 8777,
    warm_family: Optional[str] = "lstm",
    device: DeviceLike = None,
    host: str = "127.0.0.1",
) -> DashboardServer:
    """A bound dashboard server (port 0: an ephemeral port, read back from
    `server.server_address`). Its engines run on `device` (the card unless
    device="cpu"; without CUDA it raises). Warms the default engine first
    so the first device snapshot does not pay for it."""
    state = DashboardState(resolve_device(device))
    if warm_family:
        _resolve_engine(state, warm_family, None).warmup([1])
    return DashboardServer((host, port), state)


def serve(port: int = 8777, warm_family: Optional[str] = "lstm", device: DeviceLike = None) -> None:
    """Start the dashboard server (blocking)."""
    server = make_server(port, warm_family, device)
    print(f"dashboard: http://127.0.0.1:{server.server_address[1]} on {server.state.device}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="EEG decoding dashboard (PyTorch port)")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: the current CUDA device)")
    args = ap.parse_args(argv)
    serve(args.port, warm_family=None if args.no_warmup else "lstm", device=args.device)


if __name__ == "__main__":
    main()
