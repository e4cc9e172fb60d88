"""Streamlit frontend — the reference UI rebuilt on the PyTorch port.

Counterpart of neural_speech_decoding_tpu/frontend/app.py. Decodes run on
the sidebar's device (empty: the current CUDA device; "cpu" on a host
without a card), and a failed capture is shown on the page.

Behavior map follows the reference page (reference: Frontend/app.py):
  * sidebar input-source selection: Test mode (mock data), or a board spec
    (replay/synthetic/native-*) with a speed control — the rebuild's
    device mode works without hardware,
  * Start runs a decoding snapshot through `run_trials_ex` and raises the
    "Recording" badge; Stop runs one more capture and lowers it
    (reference Start/Stop semantics: app.py:192-229 — improved in that the
    badge actually persists between reruns here),
  * probability cards, an 8-channel z-scored line chart of the averaged
    window (reference normalize_eeg semantics: app.py:166-170), and an
    accumulating transcript of detections (reference: app.py:270-274),
  * mock generators reproduce the reference's fake probabilities
    (focus class 0.60-0.70) and sin+modulation+noise EEG (app.py:46-66),
  * extra over the reference: latency/throughput stats from the streaming
    runtime, a model-family selector (lstm | lstm5 | eegnet | transformer)
    backed by trained .npz checkpoints, and a continuous-streaming panel
    (StreamDecoder: one prediction per hop with live updates, the
    streaming form of the 10-trial snapshot).

Run: streamlit run neural_speech_decoding_tpu_torch/frontend/app.py
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

try:
    import streamlit as st
except ImportError as e:
    raise ImportError(
        "the Streamlit page needs the streamlit package, which is not "
        "installed in this environment; the stdlib dashboard needs nothing: "
        "python -m neural_speech_decoding_tpu_torch.frontend.server"
    ) from e

from neural_speech_decoding_tpu_torch.frontend.common import (
    CHANNELS,
    CLASSES,
    SAMPLE_RATE,
    WINDOW_SECONDS,
    generate_mock_eeg,
    generate_mock_probs,
    normalize_eeg,
)

from neural_speech_decoding_tpu_torch.runtime.board import open_board
from neural_speech_decoding_tpu_torch.runtime.tester import default_model_path, run_trials_ex


# ---------------------------------------------------------------- state
@dataclass
class UIState:
    test_mode: bool = True
    running: bool = False
    word_probs: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in CLASSES}
    )
    eeg_data: Optional[np.ndarray] = None
    transcript: list = field(default_factory=list)
    last_update: str = "Never"
    status_msg: str = ""
    focus_label: str = CLASSES[0]
    stats_line: str = ""


if "nsd_state" not in st.session_state:
    st.session_state.nsd_state = UIState()
STATE: UIState = st.session_state.nsd_state

st.set_page_config(page_title="EEG Decoding (PyTorch port)", layout="wide")

st.sidebar.header("Input Source")
STATE.test_mode = st.sidebar.checkbox("Test mode (fake data)", value=STATE.test_mode)
board_spec = st.sidebar.text_input("Board spec", value="replay")
speed = st.sidebar.slider("Replay speed", 1.0, 128.0, 32.0)
trials = st.sidebar.number_input("Trials per snapshot", 1, 50, 10)
family = st.sidebar.selectbox("Model family", ["lstm", "eegnet", "transformer"])
model_path = st.sidebar.text_input(
    "Checkpoint (.pth / .npz; empty = default)", value=""
)
device = st.sidebar.text_input("Torch device (empty = the current CUDA device)", value="") or None
STATE.focus_label = st.sidebar.selectbox("Top prediction word (mock)", CLASSES)


def run_mock_cycle() -> None:
    STATE.word_probs = generate_mock_probs(STATE.focus_label)
    STATE.eeg_data = generate_mock_eeg()
    top = max(STATE.word_probs, key=STATE.word_probs.get)
    STATE.transcript.append(f"Predicted: {top}")
    STATE.last_update = time.strftime("%H:%M:%S")
    STATE.status_msg = "Mock snapshot ready."
    STATE.stats_line = ""


def capture_device_snapshot() -> None:
    STATE.status_msg = "Recording…"
    try:
        board = open_board(board_spec, speed=float(speed))
        result, stats = run_trials_ex(
            trials=int(trials),
            serial_port=board,
            model_path=model_path or None,
            verbose=False,
            model=family,
            device=device,
        )
    except Exception as exc:
        STATE.status_msg = f"Device recording failed: {exc}"
        STATE.eeg_data = None
        STATE.word_probs = {c: 0.0 for c in CLASSES}
        # nothing is recording after a failed capture — don't leave the
        # badge up with Start locked behind a doomed Stop re-capture
        STATE.running = False
        return

    if result.avg_probs is not None:
        n = min(len(CLASSES), len(result.avg_probs))
        STATE.word_probs = {
            CLASSES[i]: float(result.avg_probs[i]) for i in range(n)
        }
        top = int(np.argmax(result.avg_probs))
        STATE.transcript.append(
            f"Detected: {CLASSES[top] if top < len(CLASSES) else top}"
        )
        STATE.status_msg = "Device snapshot ready."
    else:
        STATE.word_probs = {c: 0.0 for c in CLASSES}
        STATE.status_msg = "No probabilities available."

    STATE.eeg_data = (
        normalize_eeg(result.avg_chunk) if result.avg_chunk is not None else None
    )
    STATE.stats_line = (
        f"{stats.windows_per_second:.2f} windows/s · "
        f"p50 trial→prediction {stats.latency.percentile(50) * 1e3:.1f} ms · "
        f"p50 predict-only {stats.predict_latency.percentile(50) * 1e3:.1f} ms"
    )
    STATE.last_update = time.strftime("%H:%M:%S")


# ---------------------------------------------------------------- layout
st.title("Imagined-Speech Decoding — PyTorch backend")
start_col, stop_col, badge_col = st.columns([1, 1, 1])
with start_col:
    if st.button("Start", use_container_width=True, disabled=STATE.running):
        STATE.running = True
        if STATE.test_mode:
            run_mock_cycle()
        else:
            capture_device_snapshot()
with stop_col:
    # reference Stop semantics: one more capture, then stop (app.py:213-222)
    if st.button("Stop", use_container_width=True, disabled=not STATE.running):
        if STATE.test_mode:
            run_mock_cycle()
        else:
            capture_device_snapshot()
        STATE.running = False
with badge_col:
    if STATE.running:
        st.markdown("🔴 **Recording**")
    st.caption(f"Last update: {STATE.last_update}")

if STATE.status_msg:
    st.info(STATE.status_msg)
if STATE.stats_line:
    st.caption(STATE.stats_line)

cols = st.columns(len(CLASSES))
for col, label in zip(cols, CLASSES):
    col.metric(label, f"{STATE.word_probs.get(label, 0.0) * 100:05.2f}%")

viz, transcript = st.columns([2, 1])
with viz:
    st.subheader("8-channel EEG")
    if STATE.eeg_data is not None:
        import pandas as pd

        df = pd.DataFrame(
            STATE.eeg_data, columns=[f"Ch {i + 1}" for i in range(CHANNELS)]
        )
        st.line_chart(df, height=280, use_container_width=True)
    else:
        st.info("Press Start to decode.")
with transcript:
    st.subheader("Transcript")
    if STATE.transcript:
        for line in STATE.transcript[-12:]:
            st.write(line)
    else:
        st.write("Press Start to begin.")

# ------------------------------------------------- continuous streaming
with st.expander("Continuous streaming (one prediction per hop)"):
    s1, s2, s3 = st.columns(3)
    n_preds = s1.number_input("Predictions", 1, 500, 20)
    hop_s = s2.number_input("Hop seconds", 0.2, 5.0, 1.0)
    avg_n = s3.number_input("Rolling average N", 1, 50, 10)
    if st.button("Run streaming"):
        from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
        from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder

        live = st.empty()
        try:
            engine = InferenceEngine(
                model_path or default_model_path(), model=family, device=device
            )
            decoder = StreamDecoder(
                engine,
                open_board(board_spec, speed=float(speed)),
                hop_seconds=float(hop_s),
                average_n=int(avg_n),
            )

            def show(p):
                live.markdown(
                    f"**#{p.index}** → **{p.label}** · rolling avg "
                    + " · ".join(
                        f"{c}: {v * 100:.1f}%"
                        for c, v in zip(CLASSES, p.avg_probs)
                    )
                )
                STATE.transcript.append(f"Stream #{p.index}: {p.label}")

            preds, stream_stats = decoder.run(
                int(n_preds), on_prediction=show
            )
            STATE.stats_line = (
                f"streaming: {stream_stats.windows_per_second:.2f} windows/s · "
                f"p50 window→probability "
                f"{stream_stats.latency.percentile(50) * 1e3:.1f} ms"
            )
            STATE.last_update = time.strftime("%H:%M:%S")
            st.success(f"Streamed {len(preds)} predictions.")
        except Exception as exc:
            st.error(f"Streaming failed: {exc}")

st.caption(
    f"channels: {CHANNELS} · sample rate: {SAMPLE_RATE} Hz · "
    f"window: {WINDOW_SECONDS}s · device: {device or 'cuda'}"
)
