"""Browser stimulus presenter for the collection experiment.

Own copy of neural_speech_decoding_tpu/collector/web_stimulus.py.
The reference presents the protocol through PsychoPy: a real beep through
the speakers and the cue word on a display (reference:
Neural_decoding_data_collector.py:557-580 sound, :585-616 word text,
:621-650 COOL OFF, :683-693 escape abort). The terminal presenter
(collector/stimulus.py) covers timing but is a thin subject experience;
this module serves the audiovisual protocol to any browser instead — no
PsychoPy, no GUI toolkit, stdlib only:

  python -m neural_speech_decoding_tpu_torch.collector.experiment \
      --board synthetic --stimulus web --device cpu

The subject opens http://127.0.0.1:<port>/, clicks "Join session" (one
user gesture unlocks WebAudio — browsers block autoplay), and sits the
session: a 440 Hz beep plays at each trial start, the cue word renders as
a large card during the imagination phase, "COOL OFF" between trials.
Escape (or the Abort button) posts back and raises the same AbortRequested
path as the terminal presenter's ESC.

Design: the experiment schedule stays the timing authority (presenter
calls are cheap state flips); the page polls /api/stimulus at 10 Hz and
reacts to state transitions via a monotonically increasing `seq`, so a
missed poll never replays an old beep.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from neural_speech_decoding_tpu_torch.collector.stimulus import Presenter

_PAGE = """<!DOCTYPE html>
<html><head><title>EEG Collection Session</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#eee;
        display:flex; flex-direction:column; align-items:center;
        justify-content:center; height:100vh; margin:0; }
 #card { font-size:5rem; font-weight:800; letter-spacing:.1em;
         border:3px solid #444; border-radius:24px; padding:3rem 5rem;
         min-width:12rem; text-align:center; }
 #card.word { border-color:#4f46e5; color:#fff; }
 #card.beep { border-color:#eab308; color:#eab308; }
 #card.cooloff { border-color:#10b981; color:#10b981; font-size:3rem; }
 #status { color:#9ca3af; margin-top:2rem; }
 button { background:#4f46e5; color:#fff; border:0; border-radius:8px;
          padding:.8rem 2rem; font-size:1.2rem; cursor:pointer; }
 #abort { background:#7f1d1d; margin-top:1rem; display:none; }
</style></head>
<body>
<div id="card">–</div>
<div id="status">Press Join to enable audio and start following the protocol.</div>
<button id="join" onclick="join()">Join session</button>
<button id="abort" onclick="abortSession()">Abort (Esc)</button>
<script>
let ctx = null, lastSeq = -1;
function beep() {
  if (!ctx) return;
  const o = ctx.createOscillator(), g = ctx.createGain();
  o.frequency.value = 440; o.connect(g); g.connect(ctx.destination);
  g.gain.setValueAtTime(0.4, ctx.currentTime);
  o.start(); o.stop(ctx.currentTime + 0.5);
}
async function poll() {
  try {
    const s = await (await fetch('/api/stimulus')).json();
    const card = document.getElementById('card');
    if (s.seq !== lastSeq) {
      lastSeq = s.seq;
      if (s.phase === 'beep') { beep(); card.textContent = '\\u2731'; }
      else if (s.phase === 'word') card.textContent = s.word.toUpperCase();
      else if (s.phase === 'cooloff') card.textContent = 'COOL OFF';
      else card.textContent = '\\u2013';
      card.className = s.phase;
    }
    document.getElementById('status').textContent = s.status ||
      (s.phase === 'word' ? 'imagine saying the word' : '');
  } catch (e) { /* server gone — session over */ }
  setTimeout(poll, 100);
}
function join() {
  ctx = new (window.AudioContext || window.webkitAudioContext)();
  document.getElementById('join').style.display = 'none';
  document.getElementById('abort').style.display = 'inline-block';
  poll();
}
function abortSession() { fetch('/api/abort', {method: 'POST'}); }
document.addEventListener('keydown', e => {
  if (e.key === 'Escape') abortSession();
});
</script>
</body></html>
"""


class WebPresenter(Presenter):
    """Serves the stimulus protocol over HTTP (see module docstring).

    `port=0` binds an ephemeral port (tests); the bound port is available
    as `.port`. The server runs on a daemon thread and is torn down by
    `close()`.
    """

    def __init__(self, port: int = 8778, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._state = {"phase": "idle", "word": "", "status": "", "seq": 0}
        self._abort = threading.Event()
        presenter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
                elif self.path == "/api/stimulus":
                    with presenter._lock:
                        body = json.dumps(presenter._state).encode()
                    self._send(200, body)
                else:
                    self._send(404, b'{"error": "not found"}')

            def do_POST(self):
                if self.path == "/api/abort":
                    presenter._abort.set()
                    self._send(200, b'{"ok": true}')
                else:
                    self._send(404, b'{"error": "not found"}')

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        print(f"stimulus page: http://{host}:{self.port}/")

    # -- Presenter surface ------------------------------------------------
    def _set(self, phase: str, word: str = "") -> None:
        with self._lock:
            self._state["phase"] = phase
            self._state["word"] = word
            self._state["seq"] += 1

    def beep(self) -> None:
        self._set("beep")

    def show_word(self, word: str) -> None:
        self._set("word", word)

    def cool_off(self) -> None:
        self._set("cooloff")

    def status(self, text: str) -> None:
        with self._lock:
            self._state["status"] = text

    def request_abort(self) -> None:
        self._abort.set()

    def aborted(self) -> bool:
        return self._abort.is_set()

    def close(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=2.0)
        self._server.server_close()
