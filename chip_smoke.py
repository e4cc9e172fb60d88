#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It drives neural_speech_decoding_tpu_torch (never JAX) and reads only files
of the checkout. One line per phase, each with its elapsed seconds:

  1. the card's name and power limit (nvidia-smi)
  2. build every CUDA kernel of the port from csrc/ (plain nvcc, one
     process per source, all started together)
  3. each kernel against its plain PyTorch twin on the card, at the main
     paths' shapes (B = 1, 37, 1024, 16384), with the tolerance stated, and
     both against the same arithmetic in float64; kernel, twin and bound
     times, and the library yardstick where one PyTorch call computes the
     same function; the pair sums and the rational features no more than
     twice the twin's distance from float64; the pair sums also at T = 97
     (a prime: a direct-DFT stage) and T = 1250 (10 s at 125 Hz), B = 1
     and 37, and timed on burst windows and board-like windows, with the
     number of samples each block sends down the kernel's near-zero path;
     the band grams also within one float32 ulp (BAND_GRAMS_F64_TOL) of
     each window's max|G| against float64, on the flagship's layout at
     every batch and on the logcov, logcov12 and a 16-band layout at
     B = 37, with the kernel's registers and spills, and timed at B = 1
     too, beside its padded torch.matmul yardstick in turns: each call's
     mean (CUDA events around 20 back-to-back calls), with whether L2 was
     warm, and (3d) its device-only time
  3c. the slice-3 kernels the same way: the feature kernel in Chebyshev
     mode (flags also against the rational mode's), the Clenshaw matrix
     log (on the unwhitened band covariances; library yardstick: the eigh
     route, which computes the exact log), both no more than twice the
     twin's distance from float64, with their registers and spills from
     the build log, and the zero-phase IIR cascade (also against scipy in
     float64, no more than twice the twin's distance from it; its twin, a
     loop over T, timed once; at the timed batches its launch plan, the
     registers and spills of the instantiation the plan runs, the time of
     both its launch shapes (staged in shared memory, and in global
     memory), and the staged shape with its bulk and its plain copy; both
     shapes also timed at more batches either side of the plan's switch)
  4. the LSTM path: InferenceEngine.predict_batch on 1024 synthetic raw
     windows, with the kernels' launch counts set to 0 just before and read
     just after; then 16 of those windows against the same engine on the
     CPU (max |delta logit|)
  4b. the flagship path: EnsembleEngine.from_manifest(checkpoints/
     logcov8wd_ens_manifest.json).predict_batch on the same 1024 windows
     (5 whitened logcov8 members: filter, shared features through the
     band-gram and feature kernels, 5 heads, mean softmax), counts set to 0
     before and read after; 16 windows against the same engine on the CPU
     (max |delta prob|, max |delta logit|, guard counts); warm time split
     into filter, features and heads
  5. run_trials(trials=3) on a SyntheticBoard(speed=64) under an overall
     deadline, launch counts again set to 0 before and read after
  5b. run_trials_ex(trials=3) with the flagship engine on the card, the
     same way
  4c. the flagship served with logm="chebyshev" (model_kw), predict_batch
     on the 1024 windows: launch counts (bandcov_grams and
     logcov_feats_chebyshev once, logm_clenshaw never), cold and warm
     times, 16 windows against the same engine on the CPU
  5c. run_trials_ex(trials=3) with that engine
  4d. the unwhitened checkpoints/logcov8_ens_manifest.json with
     logm="chebyshev" (the stages path: logm_clenshaw at least once a call),
     predict_batch on the 1024 windows, card against CPU
  4e. fused_preprocess(collector_stages()) on 1024 board-like windows
     against scipy float64 (iir_cascade once)
  4f. the other families, each through InferenceEngine.predict_batch on
     the same 1024 windows (eegnet3_best, tcn3_deploy, transformer3_best,
     eegnet5_best, and the LRU at its default config with parameters
     drawn with numpy from a seed): the pair-sums kernel exactly once a
     call and no other kernel, 16 windows against the same engine on the
     CPU (max |delta logit|, argmax), warm time split into filter and
     decoder
  4g. a mixed-family EnsembleEngine: the 5 flagship members with
     tcn3_best, eegnet3_best and transformer3_best (families=, per-family
     model_kw): pair sums, band grams and logcov features once each, card
     against CPU (|delta prob|, argmax, guard counts), warm time
  4h. decode_recording on a 600 s synthetic recording (75000 x 8 at hop
     1 s: 596 windows) with max_batch=256 (3 chunks) through the
     tcn3_deploy engine: card against CPU probabilities, start times
     exact, pair sums once a chunk
  5d. run_trials_ex(trials=3) with model="tcn" (the CLI's --family tcn) on
     tcn3_deploy, under the same deadline
  7. training on the card, each run with the counts set to 0 before and
     read after:
     7a. the flagship recipe (logcov8 whitened, dropout 0, noise
         augmentation 0.5, label smoothing 0.1, lr 1e-3, 120 epochs) on the
         179 three-class golden trials through train(preprocessed=...): the
         band-gram and feature kernels launched, the train loss falling,
         the time of a head-space epoch and of featurize, and the saved
         member served card against CPU (|delta prob|)
     7b. the training CLI, --model lstm at full width, one epoch on 42
         synthetic raw trial CSVs (the pair-sums kernel filters both
         splits), and its .npz served card against CPU (|delta logit|)
     7c. one full-width LSTM step (batch 32, deterministic train mode):
         every leaf's gradient card against CPU, and the step's time
         (steps/s, windows/s); autograd through the band grams, the
         Clenshaw log and the logcov kernel route against autograd through
         their twins, each forward launching its kernel
  8. the live path, all of it under a temporary directory of its own:
     8a. the native library built by g++ (its seconds and path);
         native-synthetic streamed, and native-replay of 6 trial CSVs that
         the script writes with the port's write_trial_csv, every sample
         equal to the CSVs'
     8b. StreamDecoder with lstm3_retrained at 32x real time (10
         predictions, hop 1 s, average 10) on replay:<those trials> and on
         native-replay:<them> (the C++ producer), and the flagship
         manifest at real-time speed on replay (8 predictions): latency
         p50 and p99, windows/s, fetch waits, launches a window (counts
         set to 0 before and read after), each prediction and rolling
         average against the CPU engine on the window rebuilt from its
         counter, engine stats against the CPU engine's; one LSTM
         window's decode alone; the overlap yardsticks, once each: the
         JAX loop's order (always dispatch the next window first), and
         that with the copy made after the next dispatch
     8c. collector_filter_chain_batch on 1024 board-like windows on the
         card (float32, matmul) against the float64 CPU chain, and that
         against scipy and the native DSP; run_experiment headless on
         native-synthetic for 6 trials, the chain on the card, then
         load_trials and the trials decoded on the card against the CPU
     8d. the dashboard (make_server on port 0, in a thread): POST
         /api/decode in device mode on the synthetic board and POST
         /api/stream of the flagship on replay:<trials>, the JSON fields
         against the JAX dashboard's, each round trip in ms
  9. the analysis and evaluation path, under a temporary directory of its
     own, each run of the path with the launch counts set to 0 before and
     read after:
     9a. analyze_file on a board-like 60 s CSV (8 channels at 125 Hz, in
         volts, a header and an index column) and on a small EDF written
         here, on the card against the CPU (filtered output and every
         metric within 1e-9 of the largest |value|; no kernel launched: the
         float64 filter); KuramotoSpatialFilter.transform on one window the
         same way; wall times
     9b. run_realtime on a synthetic board at 16x, 5 windows, burst
         injection: each window's metrics against the CPU's on the window
         at the same counter, with the same noise draws
     9c. run_crossval of the flagship recipe (logcov8 whitened, dropout 0)
         on 90 synthetic 3-class trial CSVs (each class its own channel
         mixing), 3 folds, 2 seeds, 30 epochs: seconds, launches (pair sums
         once, band grams and features once a fold), the headline numbers;
         the folds, inner splits, augmentation draws and y_val equal to
         those of the same call on the CPU
     9d. session_eval.evaluate of the 9c JSON with 4 s crops: every number
         finite and in [0, 1]
     9e. fit_ensemble with K=2 on the same trials, its manifest served by
         EnsembleEngine on the card and the CPU (16 windows, |delta logit|)
     9f. stream_soak of the flagship member on the replay board at 16x for
         20 hops: hops missed while busy, latency p50 and p99, one launch
         of each kernel a hop, predictions against the CPU engine on the
         windows rebuilt from their counters
     9g. the flagship's predict_batch(1024) inside device_trace and
         annotate("predict"): the trace file, and the pair-sums, gram and
         feature kernels inside the annotated range
  10. data parallelism on a one-process mesh (parallel/): meshes over the
     first min(4, count) cards (dp row i starting on card i), or the one
     card repeated; each path with
     the launch counts set to 0 before and read after, held against the
     unsharded card engine (MESH_PROB_TOL, equal argmax and guard counts)
     and the CPU engine (LOGIT_TOL); pair sums, band grams and rational
     features dp times a mesh call:
     10a. InferenceEngine(mesh=dp2), the LSTM, predict_batch(1024)
     10b. the flagship manifest with mesh=dp2, timed in turns against the
          unsharded engine
     10c. 4 flagship members with shard_members over dp2 x tp2
     10d. mai_filter_batch_sharded(1024) against mai_filter_batch
     10e. sharded_eval of one flagship member against the local count
     10f. train(mesh=dp2): the flagship recipe for MESH_EPOCHS epochs on
          the golden trials, 2 band-gram and 2 feature launches a step and
          an evaluation, held against the same run unsharded (losses
          MESH_TRAIN_RTOL, val accuracies equal, the trained members'
          logits MESH_TRAIN_LOGIT_TOL), the member served card against
          CPU; the LSTM
          for one step of 32 on 42 raw trials (both splits filtered
          dp-sharded)
     10g. the sweep tool, its logcov grid cut to the flagship combination
          (2 folds, 30 epochs, 90 synthetic trials), with --train-winner,
          the winner served card against CPU
  3d. the device-only times (torch.profiler's kernel events over 20
     back-to-back calls) of phase 3's timed calls: the band grams and
     their yardstick at B = 1, 1024 and 16384, every other kernel at
     B = 1024; after phase 9, so that 9g's trace is the process's first,
     and before phase 11
  11. the reference app's surface and the remaining entry points, under a
     temporary directory of their own, each part with the launch counts
     set to 0 before and read after, and held against the same call on
     the CPU:
     11a. utilities.tester.run_trials(trials=3) on a SyntheticBoard(speed=
          64): exactly 3 pair-sums launches, avg_probs summing to 1, the 3
          decoded windows against the CPU engine
     11b. utilities.lstm_eeg_model.SimplePredictor on a .pth written from
          lstm3_retrained.npz by the port's exporter: 16 windows against
          the CPU (|delta prob|, labels), no kernel launched (the shim's
          FilterConfig(lambd=...) is "highest": the float64 stages filter)
     11c. utilities.preprocessor.PreProcessor.transform against the CPU
     11d. NeuroPawnConnector, KnightBoard (16 config commands after the
          start, in the legacy order) and StreamingProcess on synthetic
          boards
     11e. tools.eval_models on 90 synthetic trials with --reference: the
          pair-sums kernel once (the 3-class split), every accuracy in
          [0, 1] and within one window of the CPU's
     11f. tools.fidelity_report --stages against a golden dump written
          from the CPU engine in float64 on those trials (and the tool's
          float64 reference filter): the f64 mode within LOGIT_TOL, every
          mode's numbers printed, pair sums twice (fast, turbo)
     11g. the quickstart on those trials: the pair-sums, band-gram and
          feature kernels launched, its 16-window decodes against the CPU
     11h. entry()'s forward (one pair-sums launch) against the CPU, and
          dryrun_multichip(2) on the mesh of phase 10's devices
  6. a JSON line of the kernels, then the result line

Any failure raises and exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "lstm3_retrained.npz"
FLAGSHIP = ROOT / "checkpoints" / "logcov8wd_ens_manifest.json"
FLAGSHIP_MEMBER = ROOT / "checkpoints" / "logcov8wd_ens_s0.npz"
UNWHITENED = ROOT / "checkpoints" / "logcov8_ens_manifest.json"
CHEB_KW = {"whiten": True, "dropout": 0.0, "logm": "chebyshev"}
# 4f: the families other than the LSTM and logcov, at full width
FAMILIES = (
    ("eegnet", "eegnet3_best"),
    ("tcn", "tcn3_deploy"),
    ("transformer", "transformer3_best"),
    ("eegnet5", "eegnet5_best"),
    ("lru", None),  # no shipped checkpoint: parameters drawn from a seed
)
# 4g: the flagship members with one checkpoint of three other families
MIX_MEMBERS = [ROOT / "checkpoints" / f"logcov8wd_ens_s{i}.npz" for i in range(5)] + [
    ROOT / "checkpoints" / f"{n}.npz" for n in ("tcn3_best", "eegnet3_best", "transformer3_best")
]
MIX_FAMILIES = ["logcov8"] * 5 + ["tcn", "eegnet", "transformer"]
MIX_KW = {"logcov8:whiten": True, "logcov8:dropout": 0.0}
TCN_DEPLOY = ROOT / "checkpoints" / "tcn3_deploy.npz"
# 7: training on the card
GOLDEN = ROOT / "tests" / "golden" / "reference_filtered.npz"
FLAGSHIP_KW = {"whiten": True, "dropout": 0.0}
FLAGSHIP_EPOCHS = 120  # the manifest's recipe
RECORDING_SAMPLES = 75000  # 600 s at 125 Hz
RECORDING_BATCH = 256
T, C = 625, 8
PAIRS = C * (C + 1) // 2
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate.
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12
# Pair sums reach T = 625; both versions sum 625 f32 terms of O(1) by a
# tree, in different orders. Two tree sums agree to about 2e-5 here; a
# running f32 sum over T reads about 1.7e-3 against a tree sum, so this
# limit tells the two apart.
PAIR_SUMS_ABS_TOL = 2e-4
# Band-gram pairs are float32 sums of at most 180 products (80 for
# logcov8): a running sum of n terms errs by at most n * 2^-24 of the sum
# of |terms|, which is at most the window's max|G|. So kernel and twin
# (cuBLAS) agree to 1e-5 of each window's max|G|; the limit is per window
# because a railed window's sums are 1e12 times the others'.
BAND_GRAMS_REL_TOL = 1e-5
# The gram kernel sums exact float64 products in float64 and rounds each
# pair once: against the float64 twin it errs at most half a float32 ulp of
# |G| (2^-24) plus the float64 sums' own error (n * 2^-53 of max|G|), so
# at most one float32 ulp (2^-23) of each window's max|G|.
BAND_GRAMS_F64_TOL = 1.2e-7
# Features: the JAX package's kernel-vs-stages limit, 5e-5 max(scale, 1),
# with the scale taken per window, as for the grams: a railed window's
# features (about 33) would loosen the limit for the others (about 2.4).
LOGCOV_FEATS_TOL = 5e-5
# Clenshaw: the JAX package's kernel-vs-scan limit (tests/test_pallas_logm.py:66),
# absolute, on in-domain spectra (the unwhitened band covariances: the
# shrinkage floor keeps them in [lo, hi]).
LOGM_ABS_TOL = 5e-5
# IIR cascade against its twin, over each window's max |twin|: both are
# float32 chains of 14 sections each way; the first card run (B = 37) read
# 8.5e-6 of scale between them, 4.5e-6 (kernel) and 7.6e-6 (twin) against
# float64. The limit leaves room for the larger batches' extremes.
IIR_TWIN_TOL = 3e-5
IIR_SCIPY_TOL = 1e-4  # of scale: the JAX package's own limit (tests/test_pallas_iir.py:36)
# Against the same arithmetic in float64, a kernel may err at most this
# many times as much as its float32 twin (the pair sums, the feature kernel
# in both modes, the Clenshaw kernel): each is held to the reference's own
# accuracy, not only to the reference.
F64_RATIO = 2.0
LOGIT_TOL = 1e-4  # the JAX package's f32 fidelity budget
PROB_TOL = 1e-4
# LSTM loss gradients card vs CPU, over each leaf's max(1, max|g|): the CPU
# parity tests' budget against JAX (tests/test_torch_train_models.py)
GRAD_TOL = 1e-4
# a kernel route's backward recomputes through its twin from the same
# inputs and cotangent, so the two gradients agree to rounding
ROUTE_GRAD_TOL = 1e-5
RUN_TRIALS_DEADLINE_S = 120
BATCHES = (1, 37, 1024, 16384)  # the kernel checks' batch sizes
OTHER_T = (97, 1250)  # other window lengths of the pair-sums check
TIMED = (1024, 16384)  # those also timed; the report's times are at the last
GRAM_TIMED = (1,) + TIMED  # the band grams also timed at one live window
# the band grams on other layouts (phase 3): logcov's 4 broad bands,
# logcov12's 12 (R = 900), and 16 bands of 1 to 61 rows, most not multiples of 4
GRAM_LAYOUTS = ("logcov", "logcov12", "16 bands")
L2_BYTES = 50e6  # H100 SXM L2 cache
PROFILE_LEAD = 3  # calls traced ahead of those device_ms times
IIR_SHAPE_BATCHES = (2048, 3072, 6144, 32768)  # the IIR cascade's two shapes also timed at these

_T0 = time.perf_counter()


def phase(text: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f} s] {text}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean time of `fn` on the card over `iters` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> tuple[float, float, list]:
    """Device-only time of a call of `fn`: for each CUDA kernel that the
    calls launch, the mean duration of its kernel events in a torch.profiler
    trace of PROFILE_LEAD + iters back-to-back calls (after a warm-up call), times
    its launches a call; summed over the kernels. A session may miss a
    kernel event or two (18 or 19 of 20 launches of one kernel were seen
    on an H100 with torch 2.11), so each kernel's time is the mean of the
    events it has, and the PROFILE_LEAD calls keep the iters calls clear of
    the session's start. Returns (ms, kernel events a call, kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = PROFILE_LEAD + iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name.setdefault(e["name"], []).append(e["dur"])
    if not by_name:
        raise AssertionError("the profiler recorded no kernel on the card")
    us = sum(np.mean(d) * round(len(d) / calls) for d in by_name.values())
    return us / 1e3, sum(map(len, by_name.values())) / calls, sorted(n[:60] for n in by_name)


def l2_state(nbytes: float) -> str:
    """Whether back-to-back calls on `nbytes` of input find it in L2."""
    if nbytes < L2_BYTES:
        return f"L2 warm: {nbytes / 1e6:.3g} MB re-read back to back, under the {L2_BYTES / 1e6:.0f} MB L2"
    return f"L2 cold: {nbytes / 1e6:.3g} MB streamed, over the {L2_BYTES / 1e6:.0f} MB L2"


def kernel_resources(log: str | None, kernel: str) -> str:
    """Registers, stack frame and spills of the entry function whose name
    holds `kernel`, from nvcc's -Xptxas -v log."""
    if log is None:
        return "not built in this run"
    entry = props = None
    found = {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split()[-1]
        elif "stack frame" in line and props is not None and kernel in props:
            found["spills"] = line.strip()
        elif "Used" in line and "registers" in line and entry is not None and kernel in entry:
            found["registers"] = line.split(":", 1)[1].strip()
    if not found:
        return f"{kernel} not in the build log"
    return f"{found.get('registers', '?')}; {found.get('spills', '?')}"


def synthetic_windows(n: int, seed: int) -> np.ndarray:
    """Board-like raw windows [n, T, 8]: the SyntheticBoard's sinusoids,
    slow modulation and noise, with a random phase per window and channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 125.0
    ch = np.arange(C)
    phase0 = rng.uniform(0, 2 * np.pi, (n, 1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase0)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase0)
    x = x + 0.35 * rng.standard_normal((n, T, C))
    return x.astype(np.float32)


def synthetic_recording(total: int, seed: int) -> np.ndarray:
    """A board-like continuous recording [total, 8]: the windows' sinusoids,
    slow modulation and noise, without a break."""
    rng = np.random.default_rng(seed)
    t = np.arange(total) / 125.0
    ch = np.arange(C)
    phase0 = rng.uniform(0, 2 * np.pi, (1, C))
    x = np.sin(2 * np.pi * (8 + ch) * t[:, None] + phase0)
    x = x + 0.4 * np.sin(2 * np.pi * (2 + 0.2 * ch) * t[:, None] + ch + phase0)
    x = x + 0.35 * rng.standard_normal((total, C))
    return x.astype(np.float32)


def pair_sums_inputs(b: int, seed: int, device, t_len: int = T) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((b, t_len, C)).astype(np.float32) * 40.0
    x[0, :, 3] = 0.0  # an all-zero channel: c2 = 1, s2 = 0
    if b > 2:
        x[-1] = 0.0  # an all-zero window
    return torch.from_numpy(x).to(device)


def pair_sums_bound_ms(b: int) -> tuple[float, str]:
    """Least time for the pair sums of b windows on an H100 SXM, from the
    least work the function needs. The Hilbert step is a linear map that an
    FFT does in O(T log T): a real FFT and its inverse per channel, 2.5 T
    log2 T operations each, plus T for the gain (the kernel does complex
    transforms, one series at a time: twice that). The dense [T, T]
    product of the TPU kernel (2 T^2 C) is its choice, not the floor. Then about 10 operations per sample for c2/s2 and 4 per pair
    and sample for the sums. Bytes: x read once and G written once."""
    per_window = C * (5.0 * T * np.log2(T) + T) + 10 * T * C + 4 * PAIRS * T
    nbytes = 4 * (b * T * C + b * C * C)
    t_ops, t_bytes = b * per_window / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def burst_windows(b: int, seed: int, channels=(2, 5)) -> np.ndarray:
    """pair_sums_inputs' Gaussian windows with `channels` mostly flat
    (noise of 1e-2) and three 20-sample bursts of amplitude 40 each, as a
    channel with artifact bursts records: the bursts set the channel's mean
    x^2, so hundreds of its flat samples fall under the kernel's near-zero
    threshold, more than one round of the block's threads (with all 8
    channels, more than its queue holds)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, T, C)) * 40.0).astype(np.float32)
    k = len(channels)
    quiet = 0.01 * rng.standard_normal((b, T, k))
    starts = rng.integers(0, T - 20, (b, 3, k))
    phase0 = rng.uniform(0, 2 * np.pi, (b, 3, k))
    burst = 40.0 * np.sin(0.9 * np.arange(20)[None, None, :, None] + phase0[:, :, None, :])  # [b, 3, 20, k]
    for i in range(3):
        for j in range(k):
            rows = starts[:, i, j][:, None] + np.arange(20)[None, :]
            np.add.at(quiet[:, :, j], (np.arange(b)[:, None], rows), burst[:, i, :, j])
    x[:, :, list(channels)] = quiet
    return x


def near_zero_per_block(x: torch.Tensor, refine_below: float) -> np.ndarray:
    """Samples of each 2-window block whose |z|^2 (im from the float64
    twin's operator) is below refine_below of their series' mean x^2: about
    what the kernel queues for its dense-product chains."""
    from neural_speech_decoding_tpu_torch.ops.hilbert import hilbert_matrix

    xd = x.double()
    im = torch.matmul(hilbert_matrix(x.shape[1], x.device, torch.float64), xd)
    low = (xd * xd + im * im) < refine_below * (xd * xd).mean(dim=1, keepdim=True)
    per_window = low.sum(dim=(1, 2)).cpu().numpy()
    return np.add.reduceat(per_window, np.arange(0, len(per_window), 2))


def band_grams_bound_ms(b: int, rows: int, nb: int, band_rows: int) -> tuple[float, str]:
    """Least time for the band-gram pairs of b windows: the rows read once
    and the pairs written once; 2 operations per product and pair."""
    nbytes = 4 * (b * rows * C + b * nb * PAIRS)
    t_ops = 2 * PAIRS * band_rows * b / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_band_grams(y: torch.Tensor, offsets, device_jobs: dict) -> tuple:
    """Phase 3: the gram kernel's call mean (cuda_ms) on rows y, beside its
    library yardstick, one torch.matmul on the bands zero-padded to the
    widest (the port never calls it), in turns (kernel, library, library,
    kernel); the twin's time and the bound. Both calls go into
    device_jobs for their device-only times. Returns (kernel ms, plain ms,
    bound ms, bound by, library ms, text); the kernel's and the library's
    ms are the means of their two turns."""
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams, band_grams_plain

    padded = padded_bands(y, offsets)
    pt = padded.transpose(1, 2)

    def kernel():
        return band_grams(y, offsets)

    def library():
        return torch.matmul(pt, padded)

    calls = [cuda_ms(fn, 20) for fn in (kernel, library, library, kernel)]
    b = y.shape[0]
    device_jobs[f"bandcov_grams B={b}"] = kernel
    device_jobs[f"library B={b}"] = library
    plain_ms = cuda_ms(lambda: band_grams_plain(y, offsets), 10)
    bound, by = band_grams_bound_ms(b, y.shape[1], len(offsets) - 1, offsets[-1] - offsets[0])
    text = (f"kernel call mean {calls[0]:.4f}, {calls[3]:.4f} ms ({l2_state(4 * y.numel())}); library (one "
            f"torch.matmul on bands zero-padded to {padded.shape[1]} rows) call mean {calls[1]:.4f}, "
            f"{calls[2]:.4f} ms ({l2_state(4 * padded.numel())}); plain {plain_ms:.4f} ms; "
            f"bound {bound:.4f} ms ({by})")
    return (calls[0] + calls[3]) / 2, plain_ms, bound, by, (calls[1] + calls[2]) / 2, text


def check_gram_layouts(dev) -> float:
    """Phase 3: the gram kernel on the layouts of GRAM_LAYOUTS, 37 windows
    of Gaussian rows, against its twin (BAND_GRAMS_REL_TOL) and float64
    (BAND_GRAMS_F64_TOL), each over each window's max|G|. Returns the
    largest error against the twin."""
    from neural_speech_decoding_tpu_torch.models import logcov
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams, band_grams_plain

    worst = 0.0
    for name in GRAM_LAYOUTS:
        if name.startswith("logcov"):
            _, slices = logcov._band_projector(T, get_model(name).config)
            offsets = logcov._band_offsets(slices)
        else:  # 16 bands of 1 to 61 rows
            offsets = (0,) + tuple(int(o) for o in np.cumsum(np.random.default_rng(16).integers(1, 62, 16)))
        rng = np.random.default_rng(len(offsets))
        y = torch.from_numpy(rng.standard_normal((37, offsets[-1], C)).astype(np.float32)).to(dev)
        got = band_grams(y, offsets)
        want = band_grams_plain(y, offsets)
        exact = band_grams_plain(y.double(), offsets)
        torch.cuda.synchronize()
        norm = exact.abs().amax(dim=1, keepdim=True)  # each window's max|G|
        err = ((got - want).abs() / norm).max().item()
        k64 = ((got.double() - exact).abs() / norm).max().item()
        p64 = ((want.double() - exact).abs() / norm).max().item()
        if not (got.shape == want.shape and torch.isfinite(got).all() and err <= BAND_GRAMS_REL_TOL
                and k64 <= BAND_GRAMS_F64_TOL):
            raise AssertionError(f"band grams, {name} layout: max err {err} of max|G| (tol "
                                 f"{BAND_GRAMS_REL_TOL}), {k64} against float64 (tol {BAND_GRAMS_F64_TOL})")
        widths = np.diff(offsets)
        phase(f"band grams, {name} layout ({len(widths)} bands of {widths.min()} to {widths.max()} rows, "
              f"{int((widths % 4 != 0).sum())} not a multiple of 4; R = {offsets[-1]}) B=37: max err {err:.3e} "
              f"of each window's max|G| (tol {BAND_GRAMS_REL_TOL}); vs float64: kernel {k64:.3e} "
              f"(tol {BAND_GRAMS_F64_TOL}), twin {p64:.3e}")
        worst = max(worst, err)
    return worst


def logcov_feats_bound_ms(b: int, nb: int, terms: int) -> tuple[float, str]:
    """Least time for the features of b windows and nb bands. Bytes: the
    gram pairs, traces and W W^T pairs read once, the features (float32)
    and flags (1 byte) written once. Operations per 8x8 matrix, the route
    the kernel takes: a Householder tridiagonal reduction (4/3 C^3), a
    tridiagonal inverse per pole (3 C^2), the back-transformation (2 C^3),
    the Cholesky guard (C^3 / 3) and 6 elementwise operations per pair
    (shrinkage, weighting); the twin's pivot-free Gauss-Jordan (about 29
    kFLOP for 12 poles) is not the floor."""
    per_matrix = 4 * C**3 / 3 + terms * 3 * C**2 + 2 * C**3 + C**3 / 3 + 6 * PAIRS
    nbytes = 4 * (2 * b * nb * PAIRS + b * nb + nb * PAIRS) + b * nb
    t_ops = b * nb * per_matrix / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def eig_poly_ops(degree: int) -> float:
    """Least operations for a degree-`degree` polynomial of one symmetric
    C x C matrix: an eigendecomposition by the symmetric QR algorithm
    (about 9 C^3 with the eigenvectors, Golub and Van Loan), the scalar
    Clenshaw at C eigenvalues (3 operations a degree) and V f(L) V^T
    (2 C^3). The matrix recurrence (2 C^2 (C + 1) degree with symmetry)
    is the kernels' choice, not the floor."""
    return 9 * C**3 + 3 * degree * C + 2 * C**3


def logcov_feats_cheb_bound_ms(b: int, nb: int, degree: int) -> tuple[float, str]:
    """Least time for the Chebyshev-mode features of b windows: the bytes
    of the rational mode; per matrix the polynomial's least work plus the
    Cholesky guard (C^3 / 3) and 6 elementwise operations per pair."""
    per_matrix = eig_poly_ops(degree) + C**3 / 3 + 6 * PAIRS
    nbytes = 4 * (2 * b * nb * PAIRS + b * nb + nb * PAIRS) + b * nb
    t_ops = b * nb * per_matrix / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def clenshaw_bound_ms(m: int, degree: int) -> tuple[float, str]:
    """Least time for the series of m matrices: t read once and the result
    written once (64 floats each), the polynomial's least work."""
    nbytes = 4 * 2 * C * C * m
    t_ops = m * eig_poly_ops(degree) / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def iir_bound_ms(b: int, sections: int) -> tuple[float, str]:
    """Least time for the zero-phase cascade of b windows: x read once and
    the result written once; 9 operations a section and sample in each
    direction (out = b0 y + z0; z0 = b1 y - a1 out + z1; z1 = b2 y - a2 out)."""
    samples = b * T * C
    nbytes = 4 * 2 * samples
    t_ops = 2 * 9 * sections * samples / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def padded_bands(y: torch.Tensor, offsets) -> torch.Tensor:
    """The bands of y [B, R, 8] zero-padded to the widest one,
    [B * nb, Rmax, 8]: the input of the one batched matmul timed beside the
    gram kernel as its library yardstick (the port never calls it)."""
    widths = [hi - lo for lo, hi in zip(offsets[:-1], offsets[1:])]
    padded = y.new_zeros((y.shape[0], len(widths), max(widths), C))
    for k, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        padded[:, k, : hi - lo] = y[:, lo:hi]
    return padded.reshape(-1, max(widths), C)


def logcov_kernel_inputs(b: int, seed: int, dev, logm: str = "rational"):
    """The flagship's kernel inputs for b board-like windows through the
    card's filter. Window 0 has channel 2 railed (x1e6), window 1 is all
    zero, window 2 has channel 5 at 0.002 sin. The whitener is the first
    member's with its gain on channel 5 cut tenfold: under the shipped
    whiteners (cond(W W^T) <= 21) no input can fire the guard, under this
    one it fires for windows 0 and 2, so the flags are compared where they
    are set."""
    from neural_speech_decoding_tpu_torch.config import FilterConfig
    from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
    from neural_speech_decoding_tpu_torch.models import logcov
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch

    x = synthetic_windows(b, seed)
    if b >= 3:
        x[0, :, 2] *= 1e6
        x[1] = 0.0
        x[2, :, 5] = 0.002 * np.sin(np.arange(T, dtype=np.float32) * 0.3)
    filtered = mai_filter_batch(x, FilterConfig(precision="fast"), device=dev)
    cfg = get_model("logcov8", whiten=True, dropout=0.0, logm=logm).config
    w = torch.from_numpy(load_params_npz(FLAGSHIP_MEMBER)["whitener"]).to(dev)
    w = w * torch.where(torch.arange(C, device=dev) == 5, 0.1, 1.0)[None, None, :]
    return logcov.kernel_inputs(filtered, w, cfg)


def identity_pairs(b: int, nb: int, dev) -> torch.Tensor:
    """[b, nb * 36] pairs of 8x8 identities: the Chebyshev kernels' input
    whose tridiagonal form needs no reflector and no QL sweep."""
    iu, ju = np.triu_indices(C)
    return torch.from_numpy(np.tile(np.eye(C)[iu, ju], (b, nb)).astype(np.float32)).to(dev)


def scipy_zero_phase(x_btc: np.ndarray, sos: np.ndarray) -> np.ndarray:
    """The cascade's semantics in float64 (scipy): every section forward,
    then every section backward, each from a zero state, no padding."""
    import scipy.signal

    fwd = scipy.signal.sosfilt(sos, x_btc, axis=1)
    return scipy.signal.sosfilt(sos, fwd[:, ::-1], axis=1)[:, ::-1]


def check_chebyshev_feats(dev, build_log, device_jobs: dict):
    """Phase 3c: the feature kernel in Chebyshev mode against its twin and
    float64 on the gram kernel's output (at most F64_RATIO times the twin's
    error against float64), flags against the twin's and the rational
    mode's; its call at B = TIMED[0] into device_jobs. Returns
    (max abs err, {B: times})."""
    from neural_speech_decoding_tpu_torch.models import logcov
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams
    from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import logcov_feats, logcov_feats_plain

    phase(f"chebyshev feats kernel: {kernel_resources(build_log, 'logcov_feats_cheb_kernel')}")
    err_abs, times = 0.0, {}
    for b in BATCHES:
        k = logcov_kernel_inputs(b, seed=b + 1, dev=dev, logm="chebyshev")
        lo, hi = k.scalars["lo"], k.scalars["hi"]
        c0, poles, weights = logcov._rational_log_coeffs(lo, hi, logcov.LogCovConfig().logm_terms)
        grams = band_grams(k.yw, k.offsets)
        feats, flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
        _, rational_flags = logcov_feats(grams, k.tr_scaled, k.wwt_pairs, (c0,) + poles + weights,
                                         **dict(k.scalars, logm="rational"))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want, want_flags = logcov_feats_plain(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
        end.record()
        exact, exact_flags = logcov_feats_plain(
            grams.double(), k.tr_scaled.double(), k.wwt_pairs.double(), k.coeffs, **k.scalars
        )
        torch.cuda.synchronize()
        diff = (feats - want).abs()
        norm = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)  # each window's max(scale, 1)
        err = (diff / norm).max().item()
        if not (torch.isfinite(feats).all() and err <= LOGCOV_FEATS_TOL):
            raise AssertionError(f"chebyshev feats B={b}: max err {err} of max(scale, 1) > {LOGCOV_FEATS_TOL}")
        if not (torch.equal(flags, want_flags) and torch.equal(flags, rational_flags)):
            raise AssertionError(f"chebyshev feats B={b}: flags differ from the twin's or the rational mode's")
        if b >= 3 and not (flags[0].all() and flags[2].any() and not flags.all()):
            raise AssertionError(f"chebyshev feats B={b}: the guard did not fire as the inputs demand")
        k64 = (feats.double() - exact).abs().max().item()
        p64 = (want.double() - exact).abs().max().item()
        if not k64 <= F64_RATIO * p64:
            raise AssertionError(f"chebyshev feats B={b}: {k64 / p64:.2f}x the twin's error against float64 "
                                 f"> {F64_RATIO}")
        err_abs = max(err_abs, diff.max().item())
        line = (f"chebyshev feats B={b}: max err {err:.3e} of each window's max(scale, 1) "
                f"(tol {LOGCOV_FEATS_TOL}; largest scale {norm.max().item():.3f}), max abs err "
                f"{diff.max().item():.3e}; flags equal to the twin's and the rational mode's "
                f"({int(flags.sum())} of {flags.numel()} set); vs float64: kernel max {k64:.3e}, twin max "
                f"{p64:.3e} (kernel / twin {k64 / p64:.2f}, limit {F64_RATIO}), float64 flags differ in "
                f"{int((exact_flags != flags).sum())}")
        if b in TIMED:
            nb, degree = len(k.offsets) - 1, len(k.coeffs) - 1
            f_ms = cuda_ms(lambda: logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars), 20)
            p_ms = start.elapsed_time(end)  # the twin, timed once (its first call)
            bound, by = logcov_feats_cheb_bound_ms(b, nb, degree)
            times[b] = (f_ms, p_ms, bound, by, None)
            if b == TIMED[0]:
                device_jobs["logcov_feats_chebyshev"] = functools.partial(
                    logcov_feats, grams, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
            # where the time goes: without the series (degree 0), and on
            # multiples of the identity (no reflector, no QL sweep)
            d0_ms = cuda_ms(lambda: logcov_feats(grams, k.tr_scaled, k.wwt_pairs, k.coeffs[:1], **k.scalars), 20)
            eye = identity_pairs(b, nb, dev)
            eye_grams, eye_wwt = eye / k.scalars["scale"], eye[0].reshape(nb, PAIRS)
            eye_ms = cuda_ms(lambda: logcov_feats(eye_grams, k.tr_scaled, eye_wwt, k.coeffs, **k.scalars), 20)
            line += (f"; kernel {f_ms:.4f} ms (degree 0 {d0_ms:.4f} ms, identity matrices {eye_ms:.4f} ms), "
                     f"plain {p_ms:.4f} ms (once), bound {bound:.4f} ms ({by})")
        phase(line)
        del k, grams, feats, want, exact
    return err_abs, times


def check_clenshaw(dev, build_log, device_jobs: dict):
    """Phase 3c: the Clenshaw kernel on the unwhitened logcov8 band
    covariances of board-like windows (in the domain by the shrinkage
    floor), against its twin and float64 (at most F64_RATIO times the
    twin's error); the port's logm="eigh" route
    (torch.linalg.eigh in batches of at most 16384 matrices, log, product)
    as the library yardstick: it computes the exact log, not the
    polynomial; the kernel's call at B = TIMED[0] into device_jobs.
    Returns (max abs err, {B: times})."""
    from neural_speech_decoding_tpu_torch.config import FilterConfig
    from neural_speech_decoding_tpu_torch.models import logcov
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops import spd
    from neural_speech_decoding_tpu_torch.ops.kernels.logm import (
        clenshaw,
        logm_spd_chebyshev,
        logm_spd_chebyshev_plain,
    )
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch

    cfg = get_model("logcov8", logm="chebyshev").config
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)

    phase(f"clenshaw kernel: {kernel_resources(build_log, 'logm_clenshaw_kernel')}")
    err_abs, times = 0.0, {}
    for b in BATCHES:
        filtered = mai_filter_batch(synthetic_windows(b, seed=b + 2), FilterConfig(precision="fast"), device=dev)
        s = logcov.band_covariances(filtered, cfg)  # [b, 8, 8, 8]
        got = logm_spd_chebyshev(s, coeffs, lo, hi)
        want = logm_spd_chebyshev_plain(s, coeffs, lo, hi)
        exact = logm_spd_chebyshev_plain(s.double(), coeffs, lo, hi)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= LOGM_ABS_TOL):
            raise AssertionError(f"clenshaw B={b}: max abs err {err} > {LOGM_ABS_TOL}")
        if not torch.equal(got, got.transpose(-1, -2)):
            raise AssertionError(f"clenshaw B={b}: the result is not symmetric")
        k64 = (got.double() - exact).abs().max().item()
        p64 = (want.double() - exact).abs().max().item()
        if not k64 <= F64_RATIO * p64:
            raise AssertionError(f"clenshaw B={b}: {k64 / p64:.2f}x the twin's error against float64 > {F64_RATIO}")
        err_abs = max(err_abs, err)
        line = (f"logm clenshaw B={b} ({s.shape[0] * s.shape[1]} matrices, degree {cfg.cheb_degree}): "
                f"max abs err {err:.3e} (tol {LOGM_ABS_TOL}); vs float64: kernel max {k64:.3e}, twin max "
                f"{p64:.3e} (kernel / twin {k64 / p64:.2f}, limit {F64_RATIO}); largest |logm| "
                f"{exact.abs().max().item():.3f}")
        if b in TIMED:
            t, _ = spd.chebyshev_domain_map(s, lo, hi)
            t = t.reshape(-1, C, C).contiguous()
            k_ms = cuda_ms(lambda: clenshaw(t, coeffs), 20)
            d0_ms = cuda_ms(lambda: clenshaw(t, coeffs[:1]), 20)
            eye = (0.3 * torch.eye(C, device=dev)).expand_as(t).contiguous()
            eye_ms = cuda_ms(lambda: clenshaw(eye, coeffs), 20)
            p_ms = cuda_ms(lambda: spd.clenshaw(t, coeffs), 2)
            w_ms = cuda_ms(lambda: logm_spd_chebyshev(s, coeffs, lo, hi), 10)
            l_ms = cuda_ms(lambda: spd.logm_eigh(s), 3)
            bound, by = clenshaw_bound_ms(t.shape[0], cfg.cheb_degree)
            times[b] = (k_ms, p_ms, bound, by, l_ms)
            if b == TIMED[0]:
                device_jobs["logm_clenshaw"] = functools.partial(clenshaw, t, coeffs)
            line += (f"; kernel {k_ms:.4f} ms (degree 0 {d0_ms:.4f} ms, identity matrices {eye_ms:.4f} ms; "
                     f"wrapper with the torch map and log(tr/C) {w_ms:.4f} ms), "
                     f"plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by}), library: the logm=eigh route "
                     f"(eigh in chunks of {spd.EIGH_BATCH} + log + product; the exact log) {l_ms:.4f} ms")
        phase(line)
        del filtered, s, got, want, exact
    return err_abs, times


def check_iir(dev, build_log, device_jobs: dict):
    """Phase 3c: the zero-phase IIR cascade on detrended board-like windows
    against its twin (timed once: a loop over T) and scipy in float64, at
    most F64_RATIO times the twin's distance from float64; at the timed
    batches the launch plan, the registers and spills of the instantiation
    it runs, the time of both launch shapes (staged in shared memory at
    G = 2, in global memory at G = 1; each also against the twin), and the
    staged shape's bulk copy against its plain copy; then both shapes at
    IIR_SHAPE_BATCHES, either side of the plan's switch; the kernel's call
    at B = TIMED[0] into device_jobs. Returns (max abs err, {B: times})."""
    from neural_speech_decoding_tpu_torch.ops.kernels.iir import (
        STAGED_LANES,
        _launch,
        _shape,
        card_limits,
        collector_stages,
        iir_cascade,
        iir_cascade_plain,
        launch_plan,
        slots,
        stack_sos,
    )

    sos = stack_sos(collector_stages())
    sections = sos.shape[0]
    limits = card_limits(dev)
    phase(f"iir cascade: card limits (SMs, opt-in shared memory a block) {limits}")
    err_abs, times = 0.0, {}
    for b in BATCHES:
        x = torch.from_numpy(synthetic_windows(b, seed=b + 3)).to(dev)
        x = x - x.mean(dim=1, keepdim=True)
        got = iir_cascade(x, sos)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = iir_cascade_plain(x, sos)
        end.record()
        torch.cuda.synchronize()
        norm = want.abs().amax(dim=(1, 2), keepdim=True)  # each window's max |twin|
        diff = (got - want).abs()
        err = (diff / norm).max().item()
        ref = torch.from_numpy(scipy_zero_phase(x.cpu().double().numpy(), sos).copy())
        rnorm = ref.abs().amax(dim=(1, 2), keepdim=True)
        k_ref = ((got.cpu().double() - ref).abs() / rnorm).max().item()
        p_ref = ((want.cpu().double() - ref).abs() / rnorm).max().item()
        if not (torch.isfinite(got).all() and err <= IIR_TWIN_TOL and k_ref <= IIR_SCIPY_TOL):
            raise AssertionError(f"iir B={b}: err {err} of scale vs twin (tol {IIR_TWIN_TOL}), "
                                 f"{k_ref} vs scipy float64 (tol {IIR_SCIPY_TOL})")
        if not k_ref <= F64_RATIO * p_ref:
            raise AssertionError(f"iir B={b}: {k_ref / p_ref:.2f}x the twin's error against float64 > {F64_RATIO}")
        err_abs = max(err_abs, diff.max().item())
        line = (f"iir cascade B={b} ({sections} sections): max err {err:.3e} of each window's scale "
                f"vs the twin (tol {IIR_TWIN_TOL}), max abs {diff.max().item():.3e}; vs scipy float64: "
                f"kernel {k_ref:.3e}, twin {p_ref:.3e} (kernel / twin {k_ref / p_ref:.2f}, limit {F64_RATIO}; "
                f"tol {IIR_SCIPY_TOL})")
        if b in TIMED:
            plan = launch_plan(b, T, C, sections, *limits)
            k = slots(sections, plan.lanes)
            by_shape = []  # both shapes, each against the twin; also the card's warm-up
            for staged, g in ((True, STAGED_LANES), (False, 1)):
                shape = _shape(staged, g, b, T, C, sections, limits[1])
                got_s = _launch(x, sos, shape)
                err_s = ((got_s - want).abs() / norm).max().item()
                if not err_s <= IIR_TWIN_TOL:
                    raise AssertionError(f"iir B={b} staged={staged}: err {err_s} of scale vs twin "
                                         f"(tol {IIR_TWIN_TOL})")
                by_shape.append(f"{'staged' if staged else 'global'} G={g} W={shape.windows} "
                                f"{cuda_ms(lambda: _launch(x, sos, shape), 20):.4f} ms"
                                f"{'' if torch.equal(got_s, got) else ' (not bit-equal to the plan)'}")
                del got_s
            k_ms = cuda_ms(lambda: iir_cascade(x, sos), 20)
            p_ms = start.elapsed_time(end)  # the twin, timed once
            bound, by = iir_bound_ms(b, sections)
            times[b] = (k_ms, p_ms, bound, by, None)
            if b == TIMED[0]:
                device_jobs["iir_cascade"] = functools.partial(iir_cascade, x, sos)
            line += f"; kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms (once), bound {bound:.4f} ms ({by})"
            phase(line)
            phase(f"iir cascade B={b} plan: G={plan.lanes} lanes a series, K={k} sections a lane, "
                  f"W={plan.windows} windows a block, {plan.blocks} blocks of {plan.threads} threads, "
                  f"{plan.shared_bytes} B shared memory a block (staged {plan.staged}); "
                  f"{kernel_resources(build_log, f'iir_cascade_kernelILi{k}ELb{int(plan.staged)}E')}")
            phase(f"iir cascade B={b} by shape: " + "; ".join(by_shape))
            # the staged shape's two copies: bulk (aligned x) and plain (x 4 bytes off 16-byte alignment)
            staged = _shape(True, STAGED_LANES, b, T, C, sections, limits[1])
            flat = torch.empty(x.numel() + 1, device=dev)
            flat[1:] = x.reshape(-1)
            shifted = flat[1:].view(x.shape)
            if not torch.equal(_launch(shifted, sos, staged), _launch(x, sos, staged)):
                raise AssertionError(f"iir B={b}: the plain copy's result differs from the bulk copy's")
            copy_ms = [cuda_ms(lambda: _launch(v, sos, staged), 20) for v in (x, shifted, shifted, x)]
            phase(f"iir cascade B={b} staged copy: bulk {copy_ms[0]:.4f}, {copy_ms[3]:.4f} ms; plain "
                  f"(input 4 bytes off 16-byte alignment) {copy_ms[1]:.4f}, {copy_ms[2]:.4f} ms")
            del flat, shifted
        else:
            phase(line)
        del x, got, want, ref
    sweep = []  # both shapes either side of the plan's switch, bit-equal to each other
    for b in IIR_SHAPE_BATCHES:
        x = 30.0 * torch.randn(b, T, C, device=dev, generator=torch.Generator(dev).manual_seed(b))
        outs, cells = [], []
        for staged, g in ((True, STAGED_LANES), (False, 1)):
            shape = _shape(staged, g, b, T, C, sections, limits[1])
            outs.append(_launch(x, sos, shape))
            cells.append(f"{'staged' if staged else 'global'} {cuda_ms(lambda: _launch(x, sos, shape), 20):.4f} ms")
        if not torch.equal(*outs):
            raise AssertionError(f"iir B={b}: the two shapes' results differ")
        picked = "staged" if launch_plan(b, T, C, sections, *limits).staged else "global"
        sweep.append(f"B={b}: {', '.join(cells)} (plan: {picked})")
        del x, outs
    phase("iir cascade shapes either side of the plan's switch: " + "; ".join(sweep))
    return err_abs, times


def check_families(dev, windows: np.ndarray) -> list:
    """4f: each family of FAMILIES through InferenceEngine.predict_batch:
    the pair-sums kernel exactly once and no other kernel, 16 windows
    against the same engine on the CPU, warm time split into filter and
    decoder. Returns each call's launch counts."""
    from neural_speech_decoding_tpu_torch.models.lru import random_lru_params
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine

    b = len(windows)
    xw = torch.from_numpy(windows).to(dev)
    only_pair_sums = dict.fromkeys(kernels.LAUNCHES, 0)
    only_pair_sums["kuramoto_pair_sums"] = 1
    family_launches = []
    for family, checkpoint in FAMILIES:
        if checkpoint is None:
            source = dict(params=random_lru_params(seed=0))
            label = f"{family} (random parameters, seed 0)"
        else:
            source = dict(model_path=str(ROOT / "checkpoints" / f"{checkpoint}.npz"))
            label = f"{family} {checkpoint}"
        fam = InferenceEngine(model=family, **source)
        kernels.reset_launches()
        t = time.perf_counter()
        fam_probs = fam.predict_batch(windows)
        torch.cuda.synchronize()
        fam_cold_s = time.perf_counter() - t
        launches = kernels.launches()
        family_launches.append(launches)
        classes = len(fam.class_names)
        if launches != only_pair_sums:
            raise AssertionError(f"{label} predict_batch: launches {launches}, want {only_pair_sums}")
        if fam_probs.shape != (b, classes) or not np.isfinite(fam_probs).all():
            raise AssertionError(f"{label} predict_batch: bad probabilities {fam_probs.shape}")
        if np.abs(fam_probs.sum(axis=1) - 1.0).max() > 1e-5:
            raise AssertionError(f"{label} predict_batch: probabilities do not sum to 1")
        gpu_logits = fam.logits_batch(windows[:16])
        cpu_logits = InferenceEngine(model=family, device="cpu", **source).logits_batch(windows[:16])
        dl = float(np.abs(gpu_logits - cpu_logits).max())
        if not (dl <= LOGIT_TOL and np.array_equal(gpu_logits.argmax(1), cpu_logits.argmax(1))):
            raise AssertionError(f"{label} card vs cpu: max |delta logit| {dl}, argmax "
                                 f"{gpu_logits.argmax(1)} vs {cpu_logits.argmax(1)}")
        phase(f"{label} predict_batch({b}) on {dev}: {fam_cold_s:.3f} s first call; launches {launches}; "
              f"argmax counts {np.bincount(fam_probs.argmax(1), minlength=classes).tolist()}; "
              f"card vs cpu, 16 windows: max |delta logit| {dl:.3e} (tol {LOGIT_TOL}), argmax equal")
        f_ms = cuda_ms(lambda: mai_filter_batch(xw, fam.config.filter, device=dev), 5)
        filtered = mai_filter_batch(xw, fam.config.filter, device=dev)
        d_ms = cuda_ms(lambda: fam._spec.apply(fam.params, filtered), 5)
        w_ms = cuda_ms(lambda: fam.predict_batch(windows), 5)
        phase(f"{label} predict_batch({b}) warm {w_ms:.3f} ms = filter {f_ms:.3f} ms + "
              f"decoder {d_ms:.3f} ms + host")
        del fam, filtered
    return family_launches


def check_mixed(dev, windows: np.ndarray, w16: np.ndarray) -> dict:
    """4g: the flagship members with tcn3_best, eegnet3_best and
    transformer3_best in one EnsembleEngine: the filter, the band grams and
    the feature kernel once each, card against CPU, warm time."""
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine

    def mixed_engine(device=None):
        return EnsembleEngine([str(m) for m in MIX_MEMBERS], model="logcov8", families=MIX_FAMILIES,
                              model_kw=MIX_KW, device=device)

    b = len(windows)
    mix = mixed_engine()
    kernels.reset_launches()
    t = time.perf_counter()
    probs = mix.predict_batch(windows)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = kernels.launches()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(kuramoto_pair_sums=1, bandcov_grams=1, logcov_feats=1)
    if launches != want:
        raise AssertionError(f"mixed ensemble predict_batch: launches {launches}, want {want}")
    if probs.shape != (b, 3) or not np.isfinite(probs).all() or np.abs(probs.sum(1) - 1).max() > 1e-5:
        raise AssertionError("mixed ensemble predict_batch: bad probabilities")
    phase(f"mixed ensemble predict_batch({b}) on {dev}: {cold_s:.3f} s first call; {mix.num_members} "
          f"members in groups {list(dict.fromkeys(mix.families))}, shared features {mix._shared_featurize}; "
          f"launches {launches}; argmax counts {np.bincount(probs.argmax(1), minlength=3).tolist()}")
    before = mix.stats
    gpu_probs = mix.predict_batch(w16)
    gpu_flagged = mix.stats["guard_flagged"] - before["guard_flagged"]
    cpu_mix = mixed_engine("cpu")
    cpu_probs = cpu_mix.predict_batch(w16)
    dp = float(np.abs(gpu_probs - cpu_probs).max())
    if not (dp <= PROB_TOL and np.array_equal(gpu_probs.argmax(1), cpu_probs.argmax(1))
            and gpu_flagged == cpu_mix.stats["guard_flagged"]):
        raise AssertionError(f"mixed ensemble card vs cpu: |dprob| {dp}, guard counts "
                             f"{gpu_flagged} vs {cpu_mix.stats['guard_flagged']}")
    w_ms = cuda_ms(lambda: mix.predict_batch(windows), 5)
    phase(f"mixed ensemble card vs cpu, 16 windows: max |delta prob| {dp:.3e} (tol {PROB_TOL}), argmax "
          f"equal; guard_flagged {gpu_flagged} = {cpu_mix.stats['guard_flagged']}; "
          f"predict_batch({b}) warm {w_ms:.3f} ms")
    return launches


def check_recording(dev) -> dict:
    """4h: decode_recording of a continuous recording at hop 1 s in chunks
    of RECORDING_BATCH through the tcn3_deploy engine: one pair-sums launch
    a chunk, card against CPU, start times exact."""
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine

    samples = RECORDING_SAMPLES
    rec = synthetic_recording(samples, seed=1)
    engine = InferenceEngine(str(TCN_DEPLOY), model="tcn")
    n = (samples - T) // 125 + 1
    chunks = -(-n // RECORDING_BATCH)
    kernels.reset_launches()
    t = time.perf_counter()
    probs, starts = engine.decode_recording(rec, hop_seconds=1.0, max_batch=RECORDING_BATCH)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = kernels.launches()
    if launches["kuramoto_pair_sums"] != chunks or sum(launches.values()) != chunks:
        raise AssertionError(f"decode_recording: launches {launches}, want {chunks} pair sums")
    if probs.shape != (n, 3) or not np.isfinite(probs).all() or np.abs(probs.sum(1) - 1).max() > 1e-5:
        raise AssertionError(f"decode_recording: bad probabilities {probs.shape}")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    cpu_probs, cpu_starts = InferenceEngine(str(TCN_DEPLOY), model="tcn", device="cpu").decode_recording(
        rec, hop_seconds=1.0, max_batch=RECORDING_BATCH
    )
    torch.set_num_threads(threads)
    dp = float(np.abs(probs - cpu_probs).max())
    if not (dp <= PROB_TOL and np.array_equal(probs.argmax(1), cpu_probs.argmax(1))
            and np.array_equal(starts, cpu_starts) and np.array_equal(starts, np.arange(n, dtype=np.float64))):
        raise AssertionError(f"decode_recording card vs cpu: |dprob| {dp}, start times equal "
                             f"{np.array_equal(starts, cpu_starts)}")
    w_ms = cuda_ms(lambda: engine.decode_recording(rec, hop_seconds=1.0, max_batch=RECORDING_BATCH), 3)
    phase(f"decode_recording({samples / 125:.0f} s, hop 1 s, max_batch {RECORDING_BATCH}) tcn3_deploy on {dev}: "
          f"{n} windows in {chunks} chunks, {cold_s:.3f} s first call, warm {w_ms:.3f} ms; launches {launches}; "
          f"card vs cpu max |delta prob| {dp:.3e} (tol {PROB_TOL}), argmax and start times equal")
    return launches


def check_tcn_trials() -> dict:
    """5d: run_trials_ex(trials=3) with model="tcn" (the CLI's --family tcn)
    on tcn3_deploy, under the run_trials deadline."""
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard
    from neural_speech_decoding_tpu_torch.runtime.tester import run_trials_ex

    signal.alarm(RUN_TRIALS_DEADLINE_S)
    try:
        kernels.reset_launches()
        result, _ = run_trials_ex(trials=3, serial_port=SyntheticBoard(speed=64.0), model_path=str(TCN_DEPLOY),
                                  model="tcn", verbose=False)
        torch.cuda.synchronize()
        launches = kernels.launches()
    finally:
        signal.alarm(0)
    if launches["kuramoto_pair_sums"] < 3:
        raise AssertionError(f"tcn run_trials launched the pair-sums kernel too rarely: {launches}")
    avg = result.avg_probs
    if result.trials != 3 or avg is None or avg.shape != (3,) or abs(float(avg.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"tcn run_trials: bad result {result}")
    phase(f"tcn3_deploy run_trials_ex(3, model='tcn') on SyntheticBoard(speed=64): avg_probs "
          f"{np.round(avg, 4).tolist()}; launches {launches}")
    return launches


def golden_three_class():
    """The 179 three-class trials of tests/golden/reference_filtered.npz
    (MAI-filtered; the file names carry the labels) as a TrialDataset."""
    from neural_speech_decoding_tpu_torch.config import THREE_CLASS_PREFIXES
    from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset, parse_label

    with np.load(GOLDEN, allow_pickle=False) as z:
        filtered, files = z["filtered"], [str(f) for f in z["files"]]
    labels = [parse_label(f, THREE_CLASS_PREFIXES) for f in files]
    keep = [i for i, label in enumerate(labels) if label is not None]
    return TrialDataset(
        windows=filtered[keep],
        labels=np.asarray([labels[i] for i in keep], np.int32),
        class_prefixes=THREE_CLASS_PREFIXES,
        files=tuple(files[i] for i in keep),
    )


def train_flagship(dev, w16: np.ndarray, smi: str) -> dict:
    """7a: the flagship recipe (checkpoints/logcov8wd_ens_manifest.json:
    logcov8, whitened, dropout 0, noise augmentation 0.5, label smoothing
    0.1, lr 1e-3, constant schedule, 120 epochs) on the 179 golden trials
    through train(preprocessed=...), counts set to 0 before and read
    after; the loss must fall; the saved member served card against CPU."""
    from neural_speech_decoding_tpu_torch.io.params_io import save_params_npz
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, train

    ds = golden_three_class()
    if len(ds) != 179:
        raise AssertionError(f"golden three-class trials: {len(ds)}, want 179")
    cfg = TrainConfig(learning_rate=1e-3, label_smoothing=0.1, augment_prob=0.5, epochs=FLAGSHIP_EPOCHS)
    kernels.reset_launches()
    t = time.perf_counter()
    params, hist = train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg, preprocessed=ds.windows,
                         verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = kernels.launches()
    if launches["bandcov_grams"] < 1 or launches["logcov_feats"] < 1:
        raise AssertionError(f"flagship training launched no band-gram or feature kernel: {launches}")
    first, last = hist[0]["train_loss"], hist[-1]["train_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"flagship training: train loss {first} -> {last} did not fall")
    epoch_s = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / (len(hist) - 1)
    best = max(h["val_accuracy"] for h in hist)
    phase(f"7a flagship recipe on {dev} ({smi}): train({len(ds)} golden trials, {len(hist)} epochs) "
          f"{train_s:.3f} s, {epoch_s * 1e3:.3f} ms a head-space epoch; launches {launches}; train loss "
          f"{first:.4f} -> {last:.4f}; val accuracy {hist[0]['val_accuracy']:.3f} -> {hist[-1]['val_accuracy']:.3f} "
          f"(best {best:.3f})")
    spec = get_model("logcov8", **FLAGSHIP_KW)
    x = torch.from_numpy(ds.windows).to(dev)
    feat_ms = cuda_ms(lambda: spec.featurize(params, x), 5)
    phase(f"7a featurize({len(ds)}) on {dev}: {feat_ms:.4f} ms")
    with tempfile.TemporaryDirectory() as d:
        member = Path(d) / "member.npz"
        save_params_npz(member, params)
        gpu = InferenceEngine(str(member), model="logcov8", model_kw=FLAGSHIP_KW).predict_batch(w16)
        cpu = InferenceEngine(str(member), model="logcov8", model_kw=FLAGSHIP_KW, device="cpu").predict_batch(w16)
    dp = float(np.abs(gpu - cpu).max())
    if not (dp <= PROB_TOL and np.array_equal(gpu.argmax(1), cpu.argmax(1))):
        raise AssertionError(f"trained member card vs cpu: max |delta prob| {dp}")
    phase(f"7a trained member served card vs cpu, 16 windows: max |delta prob| {dp:.3e} (tol {PROB_TOL}), "
          "argmax equal")
    return launches


def train_cli(dev, w16: np.ndarray) -> dict:
    """7b: `python -m neural_speech_decoding_tpu_torch.train` in process,
    --model lstm at full width (hidden 48, 2 layers, T 625), one epoch on
    42 synthetic raw trial CSVs written to a temporary directory, on the
    default device (the card); then the written .npz served card against
    CPU."""
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.train.__main__ import main as train_main

    with tempfile.TemporaryDirectory() as d:
        raw = synthetic_windows(42, seed=7) * 20.0
        for i, x in enumerate(raw):
            cls = ("food", "water", "backgroundnoise")[i % 3]
            np.savetxt(Path(d) / f"{cls}_{i:04d}.csv", x, delimiter=",", fmt="%.7f")
        out = Path(d) / "lstm.npz"
        kernels.reset_launches()
        t = time.perf_counter()
        train_main(["--model", "lstm", "--data-dir", d, "--epochs", "1", "--batch-size", "32", "--out", str(out)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        launches = kernels.launches()
        if launches["kuramoto_pair_sums"] < 2:
            raise AssertionError(f"the CLI filtered its splits without the pair-sums kernel: {launches}")
        gpu = InferenceEngine(str(out)).logits_batch(w16)
        cpu = InferenceEngine(str(out), device="cpu").logits_batch(w16)
    dl = float(np.abs(gpu - cpu).max())
    if not (np.isfinite(gpu).all() and dl <= LOGIT_TOL and np.array_equal(gpu.argmax(1), cpu.argmax(1))):
        raise AssertionError(f"CLI-trained LSTM card vs cpu: max |delta logit| {dl}")
    phase(f"7b train CLI --model lstm (hidden 48, 2 layers), 42 raw trials, 1 epoch on {dev}: {cli_s:.3f} s; "
          f"launches {launches}; its .npz served card vs cpu, 16 windows: max |delta logit| {dl:.3e} "
          f"(tol {LOGIT_TOL}), argmax equal")
    return launches


def _lstm_loss_grads(spec, init, x: np.ndarray, y: np.ndarray, device):
    from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
    from neural_speech_decoding_tpu_torch.train.loop import _leaves, _loss_fn

    params = params_from_jax(init, device)
    leaves = [(path, t.requires_grad_(True)) for path, t in _leaves(params)]
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    loss, _ = _loss_fn(params, xt, yt, torch.Generator(device=device), spec.apply, 0.1, None)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {path: g.cpu().numpy() for (path, _), g in zip(leaves, grads)}


def _route_grad(fn, x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    xr = x.detach().clone().requires_grad_(True)
    out = fn(xr)
    (out[0] if isinstance(out, tuple) else out).backward(ct)
    return xr.grad


def check_gradients(dev, smi: str) -> None:
    """7c: one full-width LSTM step (hidden 48, 2 layers, T 625, batch 32)
    in deterministic train mode (dropout 0, RReLU slope fixed), gradients
    card against CPU; the train step's time on the card; and autograd
    through the three kernel routes (band grams, Clenshaw, the logcov
    kernel route) against autograd through their twins on the card, each
    forward launching its kernel."""
    from neural_speech_decoding_tpu_torch.models import logcov
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops import kernels, spd
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams, band_grams_plain
    from neural_speech_decoding_tpu_torch.ops.kernels.logm import logm_spd_chebyshev
    from neural_speech_decoding_tpu_torch.train.loop import Optimizer, TrainConfig, _leaves, make_train_step

    ds = golden_three_class()
    x, y = ds.windows[:32], ds.labels[:32]
    spec = get_model("lstm", dropout=0.0, rrelu_lower=0.2, rrelu_upper=0.2)
    init = spec.init(torch.Generator().manual_seed(0))
    t = time.perf_counter()
    gpu_loss, gpu = _lstm_loss_grads(spec, init, x, y, dev)
    gpu_s = time.perf_counter() - t
    cpu_loss, cpu = _lstm_loss_grads(spec, init, x, y, torch.device("cpu"))
    worst = max(float(np.abs(gpu[k] - cpu[k]).max()) / max(1.0, float(np.abs(cpu[k]).max())) for k in cpu)
    if not worst <= GRAD_TOL:
        raise AssertionError(f"LSTM gradients card vs cpu: {worst} of max(1, max|g|) > {GRAD_TOL}")
    phase(f"7c full-width LSTM loss and gradients, batch 32, card vs cpu: loss {gpu_loss:.6f} vs {cpu_loss:.6f}; "
          f"max |delta g| {worst:.3e} of max(1, max|g|) over {len(cpu)} leaves (tol {GRAD_TOL}); "
          f"first card call {gpu_s:.3f} s")

    # the train step at the served config (dropout 0.6, RReLU sampled)
    train_spec = get_model("lstm")
    params = train_spec.init(torch.Generator(device=dev).manual_seed(0))
    for _, leaf in _leaves(params):
        leaf.requires_grad_(True)
    step = make_train_step(train_spec, Optimizer(params, TrainConfig()), label_smoothing=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).long().to(dev)
    step(params, xt, yt, gen)
    torch.cuda.synchronize()
    reps = 3
    t = time.perf_counter()
    for _ in range(reps):
        step(params, xt, yt, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / reps
    fwd_ms = cuda_ms(lambda: train_spec.apply(params, xt, train=True, generator=gen), 2)
    phase(f"7c LSTM train step (hidden 48, 2 layers, T 625, batch 32, dropout 0.6) on {dev} ({smi}): "
          f"{step_s * 1e3:.1f} ms a step = {1.0 / step_s:.3f} steps/s = {32.0 / step_s:.1f} windows/s "
          f"(mean of {reps}); train-mode forward alone {fwd_ms:.1f} ms")

    # autograd through the kernel routes against the twins, on the card
    cfg = get_model("logcov8", **FLAGSHIP_KW).config
    xw = torch.from_numpy(ds.windows[:64]).to(dev)
    w0 = logcov.fit_whitener(logcov.init_logcov_params(torch.Generator(device=dev), cfg), xw, cfg=cfg)["whitener"]
    gen = torch.Generator(device=dev).manual_seed(1)
    k = logcov.kernel_inputs(xw, w0, cfg)
    lo, hi = cfg.cheb_interval
    coeffs = logcov._cheb_log_coeffs(lo, hi, cfg.cheb_degree)
    s = logcov.band_covariances(xw, dataclasses.replace(cfg, whiten=False))
    routes = (
        ("bandcov_grams", "band_grams", lambda v: band_grams(v, k.offsets),
         lambda v: band_grams_plain(v, k.offsets), k.yw),
        ("logm_clenshaw", "logm_spd_chebyshev", lambda v: logm_spd_chebyshev(v, coeffs, lo, hi),
         lambda v: spd.logm_chebyshev(v, coeffs, lo, hi), s),
        ("logcov_feats", "the logcov kernel route", lambda v: logcov._fused_kernel_feats(v, w0, cfg),
         lambda v: logcov._stages_feats_reference(v, w0, cfg), xw),
    )
    for counter, label, kernel_fn, twin_fn, inp in routes:
        with torch.no_grad():
            ct = torch.randn(twin_fn(inp).shape, generator=gen, device=dev)
        kernels.reset_launches()
        g_kernel = _route_grad(kernel_fn, inp, ct)
        launched = kernels.launches()[counter]
        g_twin = _route_grad(twin_fn, inp, ct)
        rel = float((g_kernel - g_twin).abs().max() / g_twin.abs().max())
        if launched < 1 or not torch.isfinite(g_kernel).all() or not rel <= ROUTE_GRAD_TOL:
            raise AssertionError(f"{label} backward on the card: {counter} launches {launched}, rel {rel}")
        phase(f"7c autograd through {label} on {dev}, {tuple(inp.shape)}: {counter} launched {launched}x in the "
              f"forward; gradient vs the twin's {rel:.3e} of its max (tol {ROUTE_GRAD_TOL})")


# 8: the live path
STREAM_SPEED = 32.0  # the LSTM stream's replay speed
CHAIN_BATCH = 1024  # windows of the collector chain on the card
CHAIN_CHECKED = 64  # of them, also through scipy and the native DSP
# card float32 chain (one [T, T] operator product, TF32 off) against the
# float64 CPU chain, over each window's scale max|x|: the CPU tests' limit
CHAIN_SCALE_TOL = 1e-5
NATIVE_TOL = 1e-9  # the float64 chain against the C++ DSP (the CPU tests' limit)
# the dashboard's JSON fields (JAX frontend/server.py:250-269, frontend/common.py:58)
SNAPSHOT_FIELDS = {"word_probs", "eeg", "transcript", "status", "stats_line", "timestamp"}
STREAM_FIELDS = {"predictions", "windows_per_second", "latency_p50_ms", "latency_p90_ms", "guard_flagged"}
PREDICTION_FIELDS = {"index", "label", "probs", "avg_probs", "latency_ms"}


def write_trials(out_dir: Path, n: int, seed: int) -> None:
    """n board-like trials as the collector writes them (the port's
    write_trial_csv, 7 decimals), labels cycling food, water, backgroundnoise."""
    from neural_speech_decoding_tpu_torch.collector.chain import write_trial_csv

    labels = ("food", "water", "backgroundnoise")
    for i, w in enumerate(synthetic_windows(n, seed)):
        write_trial_csv(out_dir / f"{labels[i % 3]}_{i:04d}.csv", np.round(w.astype(np.float64), 7))


def drain(board, n: int, timeout: float = 30.0) -> np.ndarray:
    deadline = time.time() + timeout
    while board.get_board_data_count() < n:
        if time.time() > deadline:
            raise TimeoutError(f"board held {board.get_board_data_count()} < {n} samples after {timeout} s")
        time.sleep(0.005)
    return board.get_current_board_data(n)


def native_chain(x_tc: np.ndarray) -> np.ndarray:
    """The collector chain through the C++ DSP (native/nsd_dsp.cpp)."""
    from neural_speech_decoding_tpu_torch.ops.iir import _COLLECTOR_STAGES, butter_sos
    from neural_speech_decoding_tpu_torch.runtime import native

    x_ct = native.native_detrend_constant(x_tc.T)
    for kind, order, lo, hi in _COLLECTOR_STAGES:
        x_ct = native.native_sosfilt(x_ct, np.asarray(butter_sos(kind, order, lo, hi, 125.0)), zero_phase=True)
    return x_ct.T


def scipy_chain(x_tc: np.ndarray) -> np.ndarray:
    """The collector chain through scipy: detrend, then each stage forward
    and backward without padding."""
    import scipy.signal

    from neural_speech_decoding_tpu_torch.ops.iir import _COLLECTOR_STAGES, butter_sos

    y = x_tc - x_tc.mean(axis=0, keepdims=True)
    for kind, order, lo, hi in _COLLECTOR_STAGES:
        sos = np.asarray(butter_sos(kind, order, lo, hi, 125.0))
        y = scipy.signal.sosfilt(sos, scipy.signal.sosfilt(sos, y, axis=0)[::-1], axis=0)[::-1]
    return y


def stream_checked(label: str, decoder, engine_cpu, n_pred: int, smi: str, timeout: float,
                   kernel_names, source_ct: np.ndarray) -> tuple:
    """Run a StreamDecoder (its engine already warm) with the launch counts
    set to 0 before and read after; every prediction against the CPU engine
    on the window rebuilt from its counter (the board replays source_ct
    [C, total] in a loop), rolling averages against the mean of the last
    N, engine stats against the CPU engine's."""
    from neural_speech_decoding_tpu_torch.ops import kernels

    engine = decoder.engine
    before = engine.stats
    cpu_before = engine_cpu.stats
    kernels.reset_launches()
    preds, stats = decoder.run(n_pred, timeout=timeout, warm=False)
    torch.cuda.synchronize()
    launches = kernels.launches()
    if len(preds) != n_pred:
        raise AssertionError(f"{label}: {len(preds)} of {n_pred} predictions in {timeout} s")
    data = source_ct
    n = int(decoder.window_seconds * 125)
    idx = (np.asarray([p.counter for p in preds])[:, None] - n + 1 + np.arange(n)[None, :]) % data.shape[1]
    windows = np.ascontiguousarray(data[:, idx].transpose(1, 2, 0), dtype=np.float32)
    want = engine_cpu.predict_batch(windows)
    got = np.stack([p.probs for p in preds])
    dp = float(np.abs(got - want).max())
    avg_want = np.stack([want[max(0, i - decoder.average_n + 1): i + 1].mean(axis=0) for i in range(n_pred)])
    davg = float(np.abs(np.stack([p.avg_probs for p in preds]) - avg_want).max())
    labels_equal = [p.label for p in preds] == [engine.class_names[i] for i in want.argmax(1)]
    after, cpu_after = engine.stats, engine_cpu.stats
    delta = {k: after[k] - before[k] for k in after}
    cpu_delta = {k: cpu_after[k] - cpu_before[k] for k in cpu_after}
    per_window = {k: launches[k] / n_pred for k in kernel_names}
    if not (dp <= PROB_TOL and davg <= PROB_TOL and labels_equal and delta == cpu_delta
            and delta["windows"] == n_pred and all(v == 1 for v in per_window.values())):
        raise AssertionError(f"{label}: |dprob| {dp}, |davg| {davg}, labels equal {labels_equal}, stats {delta} "
                             f"vs cpu {cpu_delta}, launches a window {per_window}")
    lat, wait = stats.latency, stats.fetch_wait.summary()
    phase(f"{label}: {n_pred} predictions, latency window->probabilities p50 {lat.percentile(50) * 1e3:.2f} ms, "
          f"p99 {lat.percentile(99) * 1e3:.2f} ms, {stats.windows_per_second:.3f} windows/s, fetch waits mean "
          f"{wait['mean'] * 1e3:.3f} ms max {wait['max'] * 1e3:.3f} ms ({smi}); launches a "
          f"window {per_window}; vs cpu: max |delta prob| {dp:.3e}, |delta avg| {davg:.3e} (tol {PROB_TOL}), "
          f"labels equal {labels_equal}; stats {delta} = cpu {cpu_delta}")
    return preds, stats, launches


def check_live_path(dev, smi: str) -> list:
    """Phase 8: the boards, the stream, the collector and the dashboard on
    the card. Returns the launch counts of the runs of the path."""
    import urllib.request

    from neural_speech_decoding_tpu_torch.collector.experiment import ExperimentConfig, run_experiment
    from neural_speech_decoding_tpu_torch.collector.chain import preprocess_trial
    from neural_speech_decoding_tpu_torch.frontend import server as dashboard
    from neural_speech_decoding_tpu_torch.io.dataset import load_trials
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.iir import collector_filter_chain_batch
    from neural_speech_decoding_tpu_torch.runtime import native
    from neural_speech_decoding_tpu_torch.runtime.board import open_board
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
    from neural_speech_decoding_tpu_torch.runtime.stream import StreamDecoder

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        trials = Path(tmp) / "trials"
        trials.mkdir()
        write_trials(trials, 6, seed=80)

        # 8a. the native library and boards
        fresh = not native.library_path().is_file()
        t = time.perf_counter()
        lib = native.build()
        phase(f"8a native library {lib.relative_to(ROOT)}: {'built by g++ in' if fresh else 'found, checked in'} "
              f"{time.perf_counter() - t:.3f} s")
        board = open_board("native-synthetic", speed=64.0)
        board.prepare_session()
        board.start_stream(5000)
        try:
            syn = drain(board, T)
        finally:
            board.release_session()
        if not ((np.diff(syn[0]) == 1).all() and np.isfinite(syn).all() and syn[1:].std() > 0.1):
            raise AssertionError("8a native-synthetic: counter not consecutive or samples not finite")
        board = open_board(f"native-replay:{trials}", speed=64.0)
        board.prepare_session()
        board.start_stream(5000)
        try:
            rep = drain(board, T)
        finally:
            board.release_session()
        src = np.concatenate(list(load_trials(trials, strict_shape=False).windows), axis=0)  # [T, C] f32
        idx = (rep[0].astype(np.int64)) % src.shape[0]
        if not np.array_equal(rep[1:].T.astype(np.float32), src[idx]):
            raise AssertionError("8a native-replay: samples differ from the CSVs'")
        phase(f"8a native-synthetic {syn.shape}: counter consecutive, std {syn[1:].std():.3f}; "
              f"native-replay:<6 trial CSVs> {rep.shape}: every sample equal to the CSVs' (counter {int(rep[0, 0])}..)")

        # 8b. the stream on the card
        source = np.ascontiguousarray(src.T, dtype=np.float64)  # [C, total], as both replay boards stream it
        lstm = InferenceEngine(str(CHECKPOINT), class_names=("Food", "Water", "None"))
        lstm_cpu = InferenceEngine(str(CHECKPOINT), class_names=("Food", "Water", "None"), device="cpu")
        lstm.warmup([1])
        one = torch.from_numpy(synthetic_windows(1, 81)).to(dev)
        decode_s = []
        for _ in range(3):
            t = time.perf_counter()
            lstm.predict_batch_async(one)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t)
        phase(f"8b one LSTM window's decode on {dev}: {np.median(decode_s) * 1e3:.2f} ms (median of 3, host clock "
              f"to synchronize; {smi})")
        for spec in (f"replay:{trials}", f"native-replay:{trials}"):
            decoder = StreamDecoder(lstm, open_board(spec, speed=STREAM_SPEED), hop_seconds=1.0, average_n=10)
            _, _, launches = stream_checked(
                f"8b LSTM stream, {spec.split(':')[0]}:<6 trials> at {STREAM_SPEED:g}x, hop 1 s, average 10",
                decoder, lstm_cpu, 10, smi, 120.0, ("kuramoto_pair_sums",), source)
            runs.append(launches)

        class DispatchFirst(StreamDecoder):
            """The JAX loop's order: always dispatch window i+1 before
            fetching i (the copy and event still made at dispatch)."""

            def _ready(self, staged):
                return False

        class CopyAfterNextDispatch(DispatchFirst):
            """The yardstick: each window's probabilities copied to the host
            only when fetched, behind the next window's kernels."""

            def _stage(self, probs):
                return probs, None

            def _collect(self, staged):
                return staged[0].cpu().numpy()

        for variant in (DispatchFirst, CopyAfterNextDispatch):
            yard = variant(lstm, open_board(f"replay:{trials}", speed=STREAM_SPEED), hop_seconds=1.0, average_n=10)
            _, ystats = yard.run(6, timeout=120.0, warm=False)
            ywait = ystats.fetch_wait.summary()
            phase(f"8b overlap, {variant.__name__} (LSTM, replay at {STREAM_SPEED:g}x, {ywait['count']} fetches; "
                  f"{smi}): fetch waits mean {ywait['mean'] * 1e3:.3f} ms, max {ywait['max'] * 1e3:.3f} ms; latency "
                  f"p50 {ystats.latency.percentile(50) * 1e3:.2f} ms, {ystats.windows_per_second:.3f} windows/s")

        flagship = EnsembleEngine.from_manifest(str(FLAGSHIP))
        flagship_cpu = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")
        flagship.warmup([1])
        decoder = StreamDecoder(flagship, open_board(f"replay:{trials}", speed=1.0), hop_seconds=1.0, average_n=10)
        _, _, launches = stream_checked(
            "8b flagship stream at real-time speed (1x), replay:<6 trials>, hop 1 s, average 10", decoder,
            flagship_cpu, 8, smi, 60.0, ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats"), source)
        runs.append(launches)

        # 8c. the collector chain on the card
        x = synthetic_windows(CHAIN_BATCH, 82).astype(np.float64)
        x += 3.0 * np.sin(2 * np.pi * 60 * np.arange(T) / 125.0)[None, :, None]  # mains
        x += np.random.default_rng(83).uniform(-5, 5, (CHAIN_BATCH, 1, C))  # electrode offsets
        x32 = torch.from_numpy(x.astype(np.float32)).to(dev)
        got = collector_filter_chain_batch(x32, method="matmul")
        torch.cuda.synchronize()
        chain_ms = cuda_ms(lambda: collector_filter_chain_batch(x32, method="matmul"), 20)
        ref = collector_filter_chain_batch(torch.from_numpy(x.astype(np.float32).astype(np.float64)),
                                           method="matmul").numpy()
        scale_in = np.abs(x).max(axis=(1, 2), keepdims=True)
        scale_out = np.abs(ref).max(axis=(1, 2), keepdims=True)
        diff = np.abs(got.cpu().numpy().astype(np.float64) - ref)
        err_in, err_out = float((diff / scale_in).max()), float((diff / scale_out).max())
        xs = x[:CHAIN_CHECKED].astype(np.float32).astype(np.float64)
        err_scipy = max(float(np.abs(scipy_chain(w) - r).max()) for w, r in zip(xs, ref))
        err_native = max(float(np.abs(native_chain(w) - r).max()) for w, r in zip(xs, ref))
        if not (err_in <= CHAIN_SCALE_TOL and err_scipy <= NATIVE_TOL and err_native <= NATIVE_TOL):
            raise AssertionError(f"8c collector chain: card vs float64 {err_in} of scale, float64 vs scipy "
                                 f"{err_scipy}, vs native {err_native}")
        phase(f"8c collector_filter_chain_batch({CHAIN_BATCH}) float32 matmul on {dev}: {chain_ms:.4f} ms ({smi}); "
              f"vs the float64 CPU chain {err_in:.3e} of each window's max|x| (tol {CHAIN_SCALE_TOL}), {err_out:.3e} "
              f"of its max|y|; float64 chain vs scipy {err_scipy:.3e}, vs the native DSP {err_native:.3e} "
              f"(tol {NATIVE_TOL}, {CHAIN_CHECKED} windows)")

        board = open_board("native-synthetic", speed=256.0)
        board.prepare_session()
        board.start_stream(20000)
        out = Path(tmp) / "collected"
        try:
            t = time.perf_counter()
            paths = run_experiment(board, out, ExperimentConfig(words=("water", "food", "yes"), n_reps=2,
                                                                warmup_seconds=0.0), device=dev)
            exp_s = time.perf_counter() - t
            raw = board.get_current_board_data(T)[1:].T
        finally:
            board.release_session()
        ds = load_trials(out, class_prefixes=("water", "food", "yes"))
        same = np.abs(preprocess_trial(raw, device=dev) - preprocess_trial(raw, device="cpu")).max()
        kernels.reset_launches()
        probs = lstm.predict_batch(ds.windows)
        torch.cuda.synchronize()
        launches = kernels.launches()
        runs.append(launches)
        dp = float(np.abs(probs - lstm_cpu.predict_batch(ds.windows)).max())
        if not (len(paths) == 6 and ds.windows.shape == (6, T, C) and same <= 1e-7 and dp <= PROB_TOL
                and launches["kuramoto_pair_sums"] == 1):
            raise AssertionError(f"8c experiment: {len(paths)} trials, {ds.windows.shape}, chain card vs cpu "
                                 f"{same}, decode |dprob| {dp}, launches {launches}")
        phase(f"8c run_experiment(6 trials) on native-synthetic at 256x, chain on {dev}: {exp_s:.3f} s; "
              f"load_trials {ds.windows.shape}; a trial's rounded chain card vs cpu max diff {same:.1e}; the 6 "
              f"trials decoded on the card (LSTM): argmax {probs.argmax(1).tolist()}, vs cpu max |delta prob| "
              f"{dp:.3e} (tol {PROB_TOL}); launches {launches}")

        # 8d. the dashboard
        server = dashboard.make_server(0, warm_family="lstm", device=dev)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"

        def post(path, payload):
            req = urllib.request.Request(url + path, data=json.dumps(payload).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            kernels.reset_launches()
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            return body, ms, kernels.launches()

        try:
            snap, decode_ms, launches = post("/api/decode", {"mode": "device", "board": "synthetic",
                                                             "trials": 3, "speed": 64})
            runs.append(launches)
            probs = np.array(list(snap["word_probs"].values()))
            if not (set(snap) == SNAPSHOT_FIELDS and len(probs) == 3 and abs(probs.sum() - 1) < 1e-5
                    and np.asarray(snap["eeg"]).shape == (T, C) and launches["kuramoto_pair_sums"] >= 3):
                raise AssertionError(f"8d /api/decode: fields {sorted(snap)}, probs {probs}, launches {launches}")
            body, stream_ms, launches = post("/api/stream", {
                "board": f"replay:{trials}", "family": "logcov8", "model_path": str(FLAGSHIP),
                "predictions": 4, "speed": 64, "hop_seconds": 1.0, "average_n": 10, "timeout": 120})
            runs.append(launches)
            preds = body.get("predictions", [])
            if not (set(body) == STREAM_FIELDS and len(preds) == 4
                    and all(set(p) == PREDICTION_FIELDS for p in preds)
                    and min(launches[k] for k in ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats")) >= 4):
                raise AssertionError(f"8d /api/stream: body {body}, launches {launches}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        phase(f"8d dashboard on {dev} ({smi}): POST /api/decode (device, synthetic, 3 trials, LSTM) round trip "
              f"{decode_ms:.1f} ms, fields {sorted(snap)}, word_probs "
              f"{ {k: round(v, 4) for k, v in snap['word_probs'].items()} }; POST /api/stream (replay:<6 trials>, "
              f"logcov8 flagship manifest, 4 predictions at 64x) round trip {stream_ms:.1f} ms (the ensemble's "
              f"build included), fields {sorted(body)}, latency p50 {body['latency_p50_ms']:.2f} ms, guard_flagged "
              f"{body['guard_flagged']}; launches {launches}")
    return runs


# 9: the analysis and evaluation path
ANALYSIS_REL_TOL = 1e-9  # float64 filter and metrics, card against CPU, over the largest |value|
ANALYSIS_SECONDS = 60  # the board-like CSV recording
REALTIME_WINDOWS = 5
# crossval: 30 trials a class. With 3 folds the inner training split of a
# fold holds about 52 trials and, with its augmented copies, about 78, so
# each epoch takes two steps of 32 (with 12 a class, as in a 36-trial set,
# fewer than 32 would remain and no step would run).
CV_PER_CLASS = 30
CV_KW = {"model": "logcov8", "folds": 3, "seeds": 2, "epochs": 30, "model_kw": FLAGSHIP_KW, "verbose": False}
SOAK_HOPS = 20
SOAK_SPEED = 16.0
TRACED_BATCH = 1024
PATH_KERNELS = ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats")
TRACE_KERNELS = {"kuramoto_pair_sums": "pair_sums_kernel", "bandcov_grams": "band_grams_kernel",
                 "logcov_feats": "logcov_feats_kernel"}


def write_board_csv(path: Path, seconds: int, seed: int) -> None:
    """A board-like recording as a board exports it: [T, 8] in volts, a
    header row and a sample-index column."""
    x = synthetic_recording(seconds * 125, seed).astype(np.float64) * 30e-6
    x[20 * 125 : 20 * 125 + 40, 2] += 400e-6  # an artifact burst
    rows = "\n".join(f"{i}," + ",".join(f"{v:.12e}" for v in row) for i, row in enumerate(x))
    path.write_text("index," + ",".join(f"ch{i}" for i in range(C)) + "\n" + rows + "\n")


def write_edf(path: Path, data_ct: np.ndarray, fs: int) -> None:
    """A small EDF+ file written field by field: int16 samples of the
    physical range +-500 uV, one record a second, and an annotation
    channel."""
    n_rec = data_ct.shape[1] // fs
    labels = [f"EEG C{i}" for i in range(data_ct.shape[0])] + ["EDF Annotations"]
    ns = len(labels)

    def fld(values, width):
        return b"".join(str(v).ljust(width)[:width].encode("ascii") for v in values)

    header = ("0".ljust(8) + "X X X X".ljust(80) + "Startdate 01-JAN-2026 X X X".ljust(80) + "01.01.26"
              + "00.00.00" + str(256 * (ns + 1)).ljust(8) + "EDF+C".ljust(44) + str(n_rec).ljust(8)
              + "1".ljust(8) + str(ns).ljust(4)).encode("ascii")
    header += fld(labels, 16) + fld([""] * ns, 80) + fld(["uV"] * ns, 8) + fld([-500] * ns, 8)
    header += fld([500] * ns, 8) + fld([-32768] * ns, 8) + fld([32767] * ns, 8) + fld([""] * ns, 80)
    header += fld([fs] * data_ct.shape[0] + [16], 8) + fld([""] * ns, 32)
    dig = np.clip(np.round((data_ct + 500.0) / (1000.0 / 65535.0) - 32768), -32768, 32767).astype("<i2")
    body = bytearray()
    for r in range(n_rec):
        for ch in range(data_ct.shape[0]):
            body += dig[ch, r * fs : (r + 1) * fs].tobytes()
        body += bytes(32)
    path.write_bytes(header + bytes(body))


def tree_rel_err(got, want) -> float:
    """The largest error over the numeric leaves of two nested dicts/lists,
    each over its leaf's largest |value|; strings, bools and None equal."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"keys differ: {sorted(got)} vs {sorted(want)}")
        return max([tree_rel_err(got[k], want[k]) for k in want] + [0.0])
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"lengths differ: {len(got)} vs {len(want)}")
        return max([tree_rel_err(g, w) for g, w in zip(got, want)] + [0.0])
    if isinstance(want, (bool, str)) or want is None:
        if got != want:
            raise AssertionError(f"{got!r} != {want!r}")
        return 0.0
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        raise AssertionError(f"shapes differ: {g.shape} vs {w.shape}")
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-300)) if w.size else 0.0


def recording_synthetic_board(speed: float, seed: int):
    """A streaming SyntheticBoard that keeps each distinct window that
    run_realtime reads, by its last counter, in `windows`."""
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard

    board = SyntheticBoard(speed=speed, seed=seed)
    board.windows = {}
    read = board.get_current_board_data

    def keep(n):
        data = read(n)
        board.windows.setdefault(int(data[0, -1]), data)
        return data

    board.get_current_board_data = keep
    return board


@contextlib.contextmanager
def recorded(owner, name: str):
    """Within the block, owner.<name> (a module's function or a class's
    method) keeps (args, result) of each call in the list it yields."""
    fn, own, kept = getattr(owner, name), name in vars(owner), []

    def keep(*args, **kw):
        out = fn(*args, **kw)
        kept.append((args, out))
        return out

    setattr(owner, name, keep)
    try:
        yield kept
    finally:
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def check_analysis_path(dev, smi: str, flagship) -> list:
    """Phase 9: the analysis CLIs' functions, the filter estimator, the
    cross-validation, session-eval, ensemble-fit and stream-soak tools, and
    a traced flagship call, on the card. Returns the launch counts of the
    runs of the path."""
    import os

    from neural_speech_decoding_tpu_torch.analysis.offline import analyze_file
    from neural_speech_decoding_tpu_torch.analysis.realtime import run_realtime
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kuramoto import KuramotoSpatialFilter
    from neural_speech_decoding_tpu_torch.io.dataset import load_trials, write_synthetic_trials
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
    from neural_speech_decoding_tpu_torch.tools import crossval, fit_ensemble, session_eval, stream_soak
    from neural_speech_decoding_tpu_torch.utils.tracing import TRACE_FILE, annotate, device_trace

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # 9a. offline analysis of a CSV and an EDF, card against CPU
        csv, edf = tmp / "board.csv", tmp / "small.edf"
        write_board_csv(csv, ANALYSIS_SECONDS, seed=90)
        write_edf(edf, synthetic_recording(250 * 12, 91).T.astype(np.float64) * 40.0 + 3.0, fs=250)
        for path, lambd, channel in ((csv, 1e-25, 2), (edf, 1e-34, 0)):
            kernels.reset_launches()
            t = time.perf_counter()
            metrics, filtered = analyze_file(path, lambd=lambd, channel=channel, out_dir=tmp / "out", device=dev)
            card_s = time.perf_counter() - t
            launches = kernels.launches()
            t = time.perf_counter()
            metrics_cpu, filtered_cpu = analyze_file(path, lambd=lambd, channel=channel, device="cpu")
            cpu_s = time.perf_counter() - t
            f_err = float(np.abs(filtered - filtered_cpu).max() / np.abs(filtered_cpu).max())
            m_err = tree_rel_err(metrics, metrics_cpu)
            flips = int((filtered != filtered_cpu).sum())
            if not (f_err <= ANALYSIS_REL_TOL and m_err <= ANALYSIS_REL_TOL and sum(launches.values()) == 0
                    and filtered.shape == filtered_cpu.shape and np.isfinite(filtered).all()):
                raise AssertionError(f"9a analyze_file({path.name}): filtered {f_err}, metrics {m_err}, {flips} "
                                     f"samples differ, launches {launches}")
            phase(f"9a analyze_file({path.name}, {filtered.shape[0]} ch x {filtered.shape[1]} samples at "
                  f"{metrics['fs_hz']:g} Hz, lambda {lambd:g}) on {dev}: {card_s:.3f} s wall (cpu {cpu_s:.3f} s; "
                  f"{smi}); vs cpu: filtered {f_err:.3e}, metrics {m_err:.3e} of the largest |value| (tol "
                  f"{ANALYSIS_REL_TOL}), {flips} samples not equal; SNR {metrics['snr_db_channel']:.3f} dB, unit "
                  f"{metrics['detected_unit']}, tags {metrics['tags_channel']}; no kernel launched")
        window = synthetic_recording(T, 92).T.astype(np.float64) * 25.0
        t = time.perf_counter()
        got = KuramotoSpatialFilter(lambd=1e-25, device=dev).transform(window)
        est_s = time.perf_counter() - t
        want = KuramotoSpatialFilter(lambd=1e-25, device="cpu").transform(window)
        e_err = float(np.abs(got - want).max() / np.abs(want).max())
        if not (e_err <= ANALYSIS_REL_TOL and got.dtype == np.float64):
            raise AssertionError(f"9a KuramotoSpatialFilter: {e_err} of the largest |value|")
        phase(f"9a KuramotoSpatialFilter.transform(one [8, 625] window) on {dev}: {est_s * 1e3:.2f} ms wall; vs "
              f"cpu {e_err:.3e} of the largest |value| (tol {ANALYSIS_REL_TOL})")

        # 9b. real-time analysis on a synthetic board at 16x with bursts;
        # the cpu run reads the card run's windows again, in order
        board = recording_synthetic_board(16.0, seed=93)
        board.prepare_session()
        board.start_stream(5000)
        try:
            t = time.perf_counter()
            got = run_realtime(board, n_windows=REALTIME_WINDOWS, inject="burst", seed=94, timeout=60, device=dev)
            rt_s = time.perf_counter() - t
        finally:
            board.release_session()
        seen = list(board.windows.values())
        replay = SyntheticBoard(speed=16.0)  # never started: it serves the windows seen
        replay.get_board_data_count = lambda: T
        replay.get_current_board_data = lambda n, reads=iter(seen): next(reads)
        want = run_realtime(replay, n_windows=REALTIME_WINDOWS, inject="burst", seed=94, timeout=60, device="cpu")
        r_err = tree_rel_err(got, want)
        if not (len(got) == REALTIME_WINDOWS and len(seen) == REALTIME_WINDOWS and r_err <= ANALYSIS_REL_TOL):
            raise AssertionError(f"9b run_realtime: {len(got)} windows, {len(seen)} read, metrics {r_err}")
        phase(f"9b run_realtime(synthetic at 16x, {REALTIME_WINDOWS} windows of 1 s, inject burst) on {dev}: "
              f"{rt_s:.3f} s wall ({smi}); each window's metrics vs the cpu on the window at the same counter "
              f"{r_err:.3e} (tol {ANALYSIS_REL_TOL}); SNR dB {[round(m['snr_db_channel'], 2) for m in got]}")

        # 9c. cross-validation of the flagship recipe on synthetic trials
        trials = write_synthetic_trials(tmp / "trials", CV_PER_CLASS, seed=95)
        old_data_dir = os.environ.get("NSD_DATA_DIR")
        os.environ["NSD_DATA_DIR"] = str(trials)
        try:
            draws = {}
            for label, device in (("card", dev), ("cpu", "cpu")):
                with recorded(crossval, "stratified_folds") as folds, recorded(crossval, "augment_batch_np") as augs:
                    kernels.reset_launches()
                    t = time.perf_counter()
                    summary = crossval.run_crossval(**CV_KW, device=device)
                    if label == "card":
                        torch.cuda.synchronize()
                    seconds = time.perf_counter() - t
                    launches = kernels.launches()
                draws[label] = ({"stratified_folds": [out for _, out in folds], "augment_batch_np": [out for _, out in augs]},
                                summary, seconds, launches)
            kept, summary, cv_s, cv_launches = draws["card"]
            kept_cpu, summary_cpu, cpu_s, _ = draws["cpu"]
            runs.append(cv_launches)
            folds_equal = all(
                len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
                for a, b in zip(kept["stratified_folds"], kept_cpu["stratified_folds"])
            ) and len(kept["stratified_folds"]) == len(kept_cpu["stratified_folds"]) == 1 + CV_KW["folds"]
            aug_equal = all(np.array_equal(ya, yb) and xa.shape == xb.shape
                            for (xa, ya), (xb, yb) in zip(kept["augment_batch_np"], kept_cpu["augment_batch_np"]))
            y_equal = [fd["y_val"] for fd in summary["fold_detail"]] == [fd["y_val"] for fd in summary_cpu["fold_detail"]]
            want = dict.fromkeys(kernels.LAUNCHES, 0)
            want.update(kuramoto_pair_sums=1, bandcov_grams=CV_KW["folds"], logcov_feats=CV_KW["folds"])
            accs = [v for row in summary["by_protocol"].values() for v in row["folds"]]
            if not (folds_equal and aug_equal and y_equal and cv_launches == want
                    and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs)
                    and summary["reference"] == [] and summary["reference_mean"] is None):
                raise AssertionError(f"9c crossval: folds equal {folds_equal}, augmentation equal {aug_equal}, "
                                     f"y_val equal {y_equal}, launches {cv_launches} (want {want}), "
                                     f"accuracies {accs}")
            bp = summary["by_protocol"]
            phase(f"9c run_crossval(logcov8 whitened, {3 * CV_PER_CLASS} trials, {CV_KW['folds']} folds, {CV_KW['seeds']} seeds, {CV_KW['epochs']} epochs) on {dev}: "
                  f"{cv_s:.3f} s ({smi}; the same call on the cpu {cpu_s:.3f} s); launches {cv_launches} (pair sums "
                  f"once, grams and features once a fold's featurize); folds, inner splits, augmentation draws and "
                  f"y_val equal to the cpu call's; nested {bp['nested']['mean']:.3f} ± {bp['nested']['std']:.3f}, "
                  f"last {bp['last']['mean']:.3f}, swa {bp['swa']['mean']:.3f}, biased {bp['biased']['mean']:.3f}, "
                  f"per-member nested {summary['per_seed_nested']['mean']:.3f} (cpu call: nested "
                  f"{summary_cpu['by_protocol']['nested']['mean']:.3f})")
            cv_json = tmp / "cv.json"
            cv_json.write_text(json.dumps(summary))

            # 9d. session accuracy from the crossval JSON, with time crops
            kernels.reset_launches()
            t = time.perf_counter()
            sess = session_eval.evaluate(str(cv_json), crop_seconds=4.0, device=dev)
            torch.cuda.synchronize()
            sess_s = time.perf_counter() - t
            launches = kernels.launches()
            runs.append(launches)
            rows = [sess[k] for k in ("session", "session_feature_avg", "per_window", "session_crop",
                                      "session_crop_feature_avg", "per_window_crop")]
            values = [v for r in rows for v in [r["mean"]] + r["folds"]]
            n_crops = len(range(0, T - 500 + 1, 62)) + 1  # 4 s crops every 62 samples, and the full window
            if not (all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values) and sess["reference_session"] is None
                    and launches["kuramoto_pair_sums"] == CV_KW["folds"] * n_crops
                    and launches["bandcov_grams"] == CV_KW["folds"] * n_crops):
                raise AssertionError(f"9d session_eval: {values}, launches {launches}")
            phase(f"9d session_eval.evaluate(the 9c JSON, 10-window sessions, 2000 draws, 4 s crops) on {dev}: "
                  f"{sess_s:.3f} s; session {sess['session']['mean']:.3f}, feature-avg "
                  f"{sess['session_feature_avg']['mean']:.3f}, per-window {sess['per_window']['mean']:.3f}, crop "
                  f"{sess['session_crop']['mean']:.3f}; launches {launches}")

            # 9e. a K=2 deployment ensemble, served on the card and the cpu
            kernels.reset_launches()
            t = time.perf_counter()
            manifest = fit_ensemble.fit_ensemble(str(tmp / "ens"), model="logcov8", seeds=2, epochs=CV_KW["epochs"],
                                                 model_kw=FLAGSHIP_KW, device=dev, verbose=False)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            fit_launches = kernels.launches()
            runs.append(fit_launches)
            want = dict.fromkeys(kernels.LAUNCHES, 0)
            want.update(kuramoto_pair_sums=1, bandcov_grams=4, logcov_feats=4)  # train and val split a member
            w16 = synthetic_windows(16, 96)
            card = EnsembleEngine.from_manifest(manifest, device=dev)
            cpu = EnsembleEngine.from_manifest(manifest, device="cpu")
            dlogit = float(np.abs(card.logits_batch(w16) - cpu.logits_batch(w16)).max())
            dprob = float(np.abs(card.predict_batch(w16) - cpu.predict_batch(w16)).max())
            if not (fit_launches == want and dlogit <= LOGIT_TOL and dprob <= PROB_TOL):
                raise AssertionError(f"9e fit_ensemble: launches {fit_launches} (want {want}), |dlogit| {dlogit}, "
                                     f"|dprob| {dprob}")
            phase(f"9e fit_ensemble(logcov8 whitened, K=2, {CV_KW['epochs']} epochs, {3 * CV_PER_CLASS} trials) on "
                  f"{dev}: {fit_s:.3f} s ({smi}); launches {fit_launches}; the manifest served on the card vs the "
                  f"cpu, 16 windows: max |delta logit| {dlogit:.3e} (tol {LOGIT_TOL}), |delta prob| {dprob:.3e}")

            # 9f. the streaming soak of the flagship member on the replay board
            engine = stream_soak.make_engine("flagship", dev)
            engine_cpu = stream_soak.make_engine("flagship", "cpu")
            preds = []
            kernels.reset_launches()
            report = stream_soak.soak(engine, "flagship", SOAK_HOPS, SOAK_SPEED, 1.0, 5.0, 120.0,
                                      on_prediction=preds.append)
            torch.cuda.synchronize()
            soak_launches = kernels.launches()
            runs.append(soak_launches)
            stream = np.concatenate(list(load_trials(trials, strict_shape=False).windows)).astype(np.float64)
            idx = (np.asarray([p.counter for p in preds])[:, None] - T + 1 + np.arange(T)[None, :]) % len(stream)
            dp = float(np.abs(np.stack([p.probs for p in preds])
                              - engine_cpu.predict_batch(stream[idx].astype(np.float32))).max())
            per_hop = {k: (soak_launches[k] - 1) / SOAK_HOPS for k in PATH_KERNELS}  # 1: the stream's warm-up
            lat = report["latency_ms"]
            if not (report["hops_decoded"] == SOAK_HOPS and all(v == 1 for v in per_hop.values()) and dp <= PROB_TOL):
                raise AssertionError(f"9f stream_soak: {report}, launches a hop {per_hop}, |dprob| {dp}")
            phase(f"9f stream_soak(flagship member, replay at {SOAK_SPEED:g}x, {SOAK_HOPS} hops of 1 s) on {dev} "
                  f"({smi}): hops_missed_while_busy {report['hops_missed_while_busy']}, latency p50 {lat['p50']:.3f} "
                  f"ms, p99 {lat['p99']:.3f} ms, {report['decoded_per_second']} decoded/s; launches a hop {per_hop} "
                  f"(plus one warm-up call); predictions vs the cpu engine on the windows at their counters "
                  f"{dp:.3e} (tol {PROB_TOL}); engine stats {report['engine_stats']}")
        finally:
            if old_data_dir is None:
                os.environ.pop("NSD_DATA_DIR", None)
            else:
                os.environ["NSD_DATA_DIR"] = old_data_dir

        # 9g. a traced flagship call
        x = synthetic_windows(TRACED_BATCH, 97)
        flagship.predict_batch(x)
        kernels.reset_launches()
        t = time.perf_counter()
        with device_trace(str(tmp / "trace"), device=dev) as log_dir, annotate("predict"):
            probs = flagship.predict_batch(x)
        traced_s = time.perf_counter() - t
        trace_launches = kernels.launches()
        runs.append(trace_launches)
        trace_path = Path(log_dir) / TRACE_FILE
        events = json.loads(trace_path.read_text())["traceEvents"]
        spans = [e for e in events if e.get("name") == "predict" and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
        if len(spans) != 1:
            raise AssertionError(f"9g trace: {len(spans)} 'predict' ranges")
        start, end = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
        gpu = [e for e in events if e.get("cat") == "kernel"]
        inside = {name: sum(1 for e in gpu if kernel in e.get("name", "") and start <= e["ts"] <= end)
                  for name, kernel in TRACE_KERNELS.items()}
        busy_ms = sum(e.get("dur", 0) for e in gpu if start <= e["ts"] <= end) / 1e3
        if not (all(v == 1 for v in inside.values()) and probs.shape == (TRACED_BATCH, 3)
                and all(trace_launches[k] == 1 for k in PATH_KERNELS)):
            raise AssertionError(f"9g trace: kernels inside the range {inside}, launches {trace_launches}, "
                                 f"{len(gpu)} kernel events")
        phase(f"9g device_trace + annotate('predict') around flagship predict_batch({TRACED_BATCH}) on {dev}: "
              f"{traced_s:.3f} s wall traced ({smi}); {trace_path.stat().st_size} bytes, {len(events)} events, "
              f"{len(gpu)} kernels, {busy_ms:.3f} ms of kernel time in the {(end - start) / 1e3:.3f} ms range; "
              f"the range holds the kernels {inside}; launches {trace_launches}")
    return runs


# 10: data parallelism on a one-process mesh
MESH_PROB_TOL = 1e-5  # a mesh engine against the unsharded card engine
MESH_EPOCHS = 10  # the flagship recipe over dp2, cut from its 120 epochs
MESH_TRAIN_RTOL = 1e-4  # mesh training's losses against the same run unsharded
MESH_TRAIN_LOGIT_TOL = 1e-5  # the two runs' trained members, |delta logit|
SWEEP_PER_CLASS = 30  # the sweep's synthetic trials (as phase 9c's)
# the sweep cut to one combination: the logcov grid's flagship recipe, 2
# folds and 30 epochs (the grid runs 3 combinations at 5 folds, 120 epochs)
SWEEP_GRID = {"model": ["logcov8"], "model_kw": [FLAGSHIP_KW], "augment": [0.5]}


def mesh_devices(dp: int, tp: int = 1) -> list:
    """The places of a dp x tp mesh, row by row, over the first
    min(4, count) cards: place (i, j) on card (i + j * dp) % cards, so that
    dp row i starts on card i when at least dp cards are visible; with one
    card, that card repeated."""
    cards = min(4, torch.cuda.device_count())
    return [f"cuda:{(i + j * dp) % cards}" for i in range(dp) for j in range(tp)]


def _mesh_launches(label: str, launches: dict, want: dict) -> None:
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, want {n}: {launches}")


def check_mesh_path(dev, smi: str, windows: np.ndarray, lstm_probs: np.ndarray, flagship, fprobs: np.ndarray) -> list:
    """Phase 10: every mesh path at full width, counts set to 0 before each
    and read after; each held against the unsharded card engine (<= 1e-5
    |delta prob|, equal argmax and guard counts) and the CPU engine (<= 1e-4
    |delta logit|); pair sums, band grams and rational features dp times a
    mesh call."""
    from neural_speech_decoding_tpu_torch.config import FilterConfig
    from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset, write_synthetic_trials
    from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
    from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
    from neural_speech_decoding_tpu_torch.models.registry import get_model
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch, mai_filter_batch_sharded
    from neural_speech_decoding_tpu_torch.parallel import make_mesh
    from neural_speech_decoding_tpu_torch.parallel.collective import sharded_eval
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
    from neural_speech_decoding_tpu_torch.tools import sweep
    from neural_speech_decoding_tpu_torch.train.loop import TrainConfig, train

    dp2 = make_mesh(mesh_devices(2), tp=1)
    dp2tp2 = make_mesh(mesh_devices(2, 2), tp=2)
    others = sorted(t.name for t in threading.enumerate() if t is not threading.current_thread())
    phase(f"10 meshes: dp2 {dp2}; dp2 x tp2 {dp2tp2} ({torch.cuda.device_count()} cards visible; {smi}); "
          f"{len(others)} other Python threads alive: {others}")
    fast = FilterConfig(precision="fast")
    w16 = windows[:16].copy()
    w16[5] = 0.0
    runs = []

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # 10a. the LSTM engine over dp2
    lstm = InferenceEngine(model_path=str(CHECKPOINT), mesh=dp2)
    kernels.reset_launches()
    probs, cold_s = timed(lambda: lstm.predict_batch(windows))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10a LSTM mesh", launches, {"kuramoto_pair_sums": 2})
    dp = float(np.abs(probs - lstm_probs).max())
    if not (dp <= MESH_PROB_TOL and np.array_equal(probs.argmax(1), lstm_probs.argmax(1))):
        raise AssertionError(f"10a LSTM mesh vs unsharded card engine: |dprob| {dp}")
    unsharded = InferenceEngine(model_path=str(CHECKPOINT))
    turns = [timed(lambda e=e: e.predict_batch(windows))[1] for e in (unsharded, lstm, lstm, unsharded)]
    dl = float(np.abs(lstm.logits_batch(w16)
                      - InferenceEngine(model_path=str(CHECKPOINT), device="cpu").logits_batch(w16)).max())
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"10a LSTM mesh vs cpu: |dlogit| {dl}")
    b = len(windows)
    phase(f"10a InferenceEngine(mesh=dp2) LSTM predict_batch({b}): {cold_s:.3f} s first call; warm, in turns "
          f"(unsharded, mesh, mesh, unsharded; host clock) {', '.join(f'{t:.3f}' for t in turns)} s; launches "
          f"{launches}; vs unsharded card |dprob| {dp:.3e} (tol {MESH_PROB_TOL}), argmax equal; vs cpu, 16 windows, "
          f"|dlogit| {dl:.3e} (tol {LOGIT_TOL})")
    del lstm, unsharded

    # 10b. the flagship over dp2
    before = flagship.stats["guard_flagged"]
    flagship.predict_batch(windows)
    flagged = flagship.stats["guard_flagged"] - before
    mesh_flagship = EnsembleEngine.from_manifest(str(FLAGSHIP), mesh=dp2)
    kernels.reset_launches()
    mprobs, cold_s = timed(lambda: mesh_flagship.predict_batch(windows))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10b flagship mesh", launches, dict.fromkeys(PATH_KERNELS, 2))
    dp = float(np.abs(mprobs - fprobs).max())
    m_flagged = mesh_flagship.stats["guard_flagged"]
    if not (dp <= MESH_PROB_TOL and np.array_equal(mprobs.argmax(1), fprobs.argmax(1)) and m_flagged == flagged):
        raise AssertionError(f"10b flagship mesh vs unsharded: |dprob| {dp}, guard {m_flagged} vs {flagged}")
    cpu_flagship = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")
    dl = float(np.abs(mesh_flagship.logits_batch(w16) - cpu_flagship.logits_batch(w16)).max())
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"10b flagship mesh vs cpu: |dlogit| {dl}")
    turns = [cuda_ms(lambda: flagship.predict_batch(windows), 5), cuda_ms(lambda: mesh_flagship.predict_batch(windows), 5),
             cuda_ms(lambda: mesh_flagship.predict_batch(windows), 5), cuda_ms(lambda: flagship.predict_batch(windows), 5)]
    phase(f"10b flagship EnsembleEngine(mesh=dp2) predict_batch({b}): {cold_s:.3f} s first call; warm, in turns "
          f"(unsharded, mesh, mesh, unsharded) {turns[0]:.3f}, {turns[1]:.3f}, {turns[2]:.3f}, {turns[3]:.3f} ms "
          f"({smi}); launches {launches}; vs unsharded card |dprob| {dp:.3e}, guard_flagged {m_flagged} = "
          f"{flagged}; vs cpu, 16 windows, |dlogit| {dl:.3e} over 5 members")
    del mesh_flagship

    # 10c. shard_members: 4 flagship members over dp2 x tp2
    manifest = json.loads(FLAGSHIP.read_text())
    paths = [str(FLAGSHIP.parent / Path(p).name) for p in manifest["members"]][:4]
    kw = dict(model="logcov8", model_kw=manifest["config"]["model_kw"])
    base4 = EnsembleEngine(paths, **kw)
    want4 = base4.predict_batch(windows)
    sharded = EnsembleEngine(paths, mesh=dp2tp2, shard_members=True, **kw)
    kernels.reset_launches()
    sprobs, cold_s = timed(lambda: sharded.predict_batch(windows))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10c shard_members", launches, dict.fromkeys(PATH_KERNELS, 2))
    dp = float(np.abs(sprobs - want4).max())
    if not (dp <= MESH_PROB_TOL and np.array_equal(sprobs.argmax(1), want4.argmax(1))
            and sharded.stats == base4.stats):
        raise AssertionError(f"10c shard_members vs unsharded: |dprob| {dp}, stats {sharded.stats} vs {base4.stats}")
    dl = float(np.abs(sharded.logits_batch(w16) - EnsembleEngine(paths, device="cpu", **kw).logits_batch(w16)).max())
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"10c shard_members vs cpu: |dlogit| {dl}")
    s_ms = cuda_ms(lambda: sharded.predict_batch(windows), 5)
    b_ms = cuda_ms(lambda: base4.predict_batch(windows), 5)
    phase(f"10c EnsembleEngine(4 members, mesh=dp2 x tp2, shard_members) predict_batch({b}): {cold_s:.3f} s first "
          f"call, warm {s_ms:.3f} ms (unsharded 4 members {b_ms:.3f} ms); launches {launches}; vs unsharded |dprob| "
          f"{dp:.3e}, stats {sharded.stats}; vs cpu, 16 windows, |dlogit| {dl:.3e} over 4 members")
    del sharded, base4

    # 10d. mai_filter_batch_sharded
    xw = torch.from_numpy(windows).to(dev)
    kernels.reset_launches()
    filtered, f_s = timed(lambda: mai_filter_batch_sharded(xw, fast, mesh=dp2))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10d sharded filter", launches, {"kuramoto_pair_sums": 2})
    ref = mai_filter_batch(xw, fast, device=dev)
    ferr = float(((filtered - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)).max())
    if not ferr <= 1e-6:
        raise AssertionError(f"10d sharded filter vs unsharded: {ferr} of each window's scale")
    fs_ms = cuda_ms(lambda: mai_filter_batch_sharded(xw, fast, mesh=dp2), 5)
    fu_ms = cuda_ms(lambda: mai_filter_batch(xw, fast, device=dev), 5)
    phase(f"10d mai_filter_batch_sharded({b}, dp2): {f_s:.3f} s first call, warm {fs_ms:.3f} ms (unsharded "
          f"{fu_ms:.3f} ms); launches {launches}; vs unsharded {ferr:.3e} of each window's scale")

    # 10e. sharded_eval with one flagship member (filter, features, head)
    spec = get_model("logcov8", **FLAGSHIP_KW)
    member = load_params_npz(FLAGSHIP_MEMBER)

    def apply_fn(p, w):
        return spec.apply(p, mai_filter_batch(w, fast, device=w.device))

    n = len(windows) - 1  # odd: padded with one window labelled -1
    labels = np.arange(n) % 3
    kernels.reset_launches()
    (acc, total), e_s = timed(lambda: sharded_eval(dp2, apply_fn, member, windows[:n], labels))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10e sharded_eval", launches, dict.fromkeys(PATH_KERNELS, 2))
    with torch.no_grad():
        local = apply_fn(params_from_jax(member, dev), xw[:n]).argmax(1).cpu().numpy()
    want_acc = float((local == labels).sum()) / n
    if not (total == n and acc == want_acc):
        raise AssertionError(f"10e sharded_eval: ({acc}, {total}) vs local ({want_acc}, {n})")
    phase(f"10e sharded_eval(dp2, one flagship member, {n} windows padded to {n + 1}): {e_s:.3f} s; accuracy "
          f"{acc:.4f} on {total} = local; launches {launches}")

    # 10f. training over dp2: the flagship recipe against the same run
    # unsharded (deterministic at dropout 0), and one LSTM step
    from neural_speech_decoding_tpu_torch.train import loop

    ds = golden_three_class()
    cfg = TrainConfig(learning_rate=1e-3, label_smoothing=0.1, augment_prob=0.5, epochs=MESH_EPOCHS)
    per_call = []  # (kind, (band-gram, feature) launches) of each sharded step and evaluation

    def counted(make, kind):
        def factory(*a, **k):
            fn = make(*a, **k)

            def call(*args):
                before = kernels.launches()
                out = fn(*args)
                after = kernels.launches()
                per_call.append((kind, (after["bandcov_grams"] - before["bandcov_grams"],
                                        after["logcov_feats"] - before["logcov_feats"])))
                return out

            return call

        return factory

    real = loop.make_sharded_train_step, loop.make_sharded_eval_fn
    loop.make_sharded_train_step = counted(real[0], "step")
    loop.make_sharded_eval_fn = counted(real[1], "evaluation")
    try:
        kernels.reset_launches()
        (params, hist), t_s = timed(lambda: train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg,
                                                  preprocessed=ds.windows, mesh=dp2, verbose=False))
        launches = kernels.launches()
    finally:
        loop.make_sharded_train_step, loop.make_sharded_eval_fn = real
    runs.append(launches)
    steps = sum(kind == "step" for kind, _ in per_call)
    evals = sum(kind == "evaluation" for kind, _ in per_call)
    wrong = [c for c in per_call if c[1] != (2, 2)]
    if wrong or steps == 0 or evals != len(hist):
        raise AssertionError(f"10f mesh training: want 2 band-gram and 2 feature launches a step and an "
                             f"evaluation; {steps} steps, {evals} evaluations, {len(hist)} epochs; off: {wrong[:4]}")
    first, last = hist[0]["train_loss"], hist[-1]["train_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"10f mesh training: train loss {first} -> {last} did not fall")
    (uparams, uhist), u_s = timed(lambda: train(ds, model="logcov8", model_kw=FLAGSHIP_KW, train_cfg=cfg,
                                                preprocessed=ds.windows, verbose=False))
    dh = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(hist, uhist) for k in ("train_loss", "val_loss"))
    same_acc = [h["val_accuracy"] for h in hist] == [h["val_accuracy"] for h in uhist]
    gpu = InferenceEngine(params=params, model="logcov8", model_kw=FLAGSHIP_KW).logits_batch(w16)
    dt = float(np.abs(gpu - InferenceEngine(params=uparams, model="logcov8", model_kw=FLAGSHIP_KW)
                      .logits_batch(w16)).max())
    if not (len(hist) == len(uhist) and dh <= MESH_TRAIN_RTOL and same_acc and dt <= MESH_TRAIN_LOGIT_TOL):
        raise AssertionError(f"10f mesh training vs unsharded: losses rel {dh} (tol {MESH_TRAIN_RTOL}), val "
                             f"accuracies equal {same_acc}, trained members |dlogit| {dt} "
                             f"(tol {MESH_TRAIN_LOGIT_TOL})")
    cpu = InferenceEngine(params=params, model="logcov8", model_kw=FLAGSHIP_KW, device="cpu").logits_batch(w16)
    dl = float(np.abs(gpu - cpu).max())
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"10f mesh-trained member card vs cpu: |dlogit| {dl}")
    phase(f"10f train(mesh=dp2) flagship recipe, {len(ds)} golden trials, {len(hist)} epochs (cut from "
          f"{FLAGSHIP_EPOCHS}): {t_s:.3f} s (unsharded, head-space path, {u_s:.3f} s); {steps} steps and {evals} "
          f"evaluations, each 2 band-gram and 2 feature launches; launches {launches}; train loss {first:.4f} -> "
          f"{last:.4f}; val accuracy {hist[-1]['val_accuracy']:.3f}; vs the unsharded card run: losses rel "
          f"{dh:.3e} (tol {MESH_TRAIN_RTOL}), val accuracies equal, trained members 16 windows |dlogit| {dt:.3e} "
          f"(tol {MESH_TRAIN_LOGIT_TOL}); served card vs cpu |dlogit| {dl:.3e}")
    raw = synthetic_windows(42, seed=7) * 20.0
    lstm_ds = TrialDataset(raw, np.arange(42, dtype=np.int32) % 3, ("food", "water", "backgroundnoise"),
                           tuple(f"{('food', 'water', 'backgroundnoise')[i % 3]}_{i:04d}.csv" for i in range(42)))
    kernels.reset_launches()
    (lparams, lhist), l_s = timed(lambda: train(lstm_ds, model="lstm", train_cfg=TrainConfig(epochs=1, batch_size=32),
                                                filter_cfg=fast, mesh=dp2, verbose=False))
    launches = kernels.launches()
    runs.append(launches)
    _mesh_launches("10f LSTM mesh training (train and val splits filtered)", launches, {"kuramoto_pair_sums": 4})
    if not np.isfinite(lhist[0]["train_loss"]):
        raise AssertionError(f"10f LSTM mesh step: loss {lhist[0]['train_loss']}")
    phase(f"10f train(mesh=dp2) LSTM (hidden 48, 2 layers), 42 raw trials, 1 epoch = one step of 32 (two shards of "
          f"16) and a sharded evaluation: {l_s:.3f} s; launches {launches}; train loss {lhist[0]['train_loss']:.4f}")

    # 10g. the sweep: one combination, then --train-winner
    with tempfile.TemporaryDirectory() as d:
        trials = write_synthetic_trials(Path(d) / "trials", SWEEP_PER_CLASS, seed=0)
        out = Path(d) / "winner.npz"
        old_env = os.environ.get("NSD_DATA_DIR")
        os.environ["NSD_DATA_DIR"] = str(trials)
        sweep.GRIDS["chip_smoke"] = SWEEP_GRID
        try:
            kernels.reset_launches()
            results, sw_s = timed(lambda: sweep.main(["--grid", "chip_smoke", "--folds", "2", "--epochs", "30",
                                                      "--train-winner", str(out)]))
            launches = kernels.launches()
        finally:
            del sweep.GRIDS["chip_smoke"]
            if old_env is None:
                os.environ.pop("NSD_DATA_DIR", None)
            else:
                os.environ["NSD_DATA_DIR"] = old_env
        runs.append(launches)
        if min(launches[n] for n in PATH_KERNELS) < 1:
            raise AssertionError(f"10g sweep left a kernel of its path unlaunched: {launches}")
        nested = results[0]["by_protocol"]["nested"]["mean"]
        gpu = InferenceEngine(str(out), model="logcov8", model_kw=FLAGSHIP_KW).logits_batch(w16)
        cpu = InferenceEngine(str(out), model="logcov8", model_kw=FLAGSHIP_KW, device="cpu").logits_batch(w16)
    dl = float(np.abs(gpu - cpu).max())
    if not (np.isfinite(nested) and dl <= LOGIT_TOL):
        raise AssertionError(f"10g sweep: nested {nested}; winner card vs cpu |dlogit| {dl}")
    phase(f"10g sweep --train-winner ({3 * SWEEP_PER_CLASS} synthetic trials; the logcov grid cut to the flagship "
          f"combination, 2 folds, 30 epochs): {sw_s:.3f} s; nested {nested:.3f}; launches {launches}; winner served "
          f"card vs cpu, 16 windows, |dlogit| {dl:.3e}")
    return runs


# 11: the reference surface, the evaluation and fidelity tools, the
# quickstart and entry.py
SURFACE_TRIALS = 90  # write_trials' board-like trials for 11e-11g
SURFACE_FILTER_TOL = 1e-6  # PreProcessor card vs CPU, over the window's max |output|: float64, then float32
LEGACY_COMMANDS = [c for x in range(1, 9) for c in (f"chon_{x}_12", f"rldadd_{x}")]


def check_reference_surface(dev, smi: str) -> list:
    """Phase 11: the reference app's import surface (utilities/), the
    model-evaluation and fidelity tools, the quickstart and
    entry.py on the card, the launch counts set to 0 before each part and
    read after it, each part held against the same call on the CPU.
    Returns the launch counts of the parts."""
    import queue

    from neural_speech_decoding_tpu_torch import entry as port_entry
    from neural_speech_decoding_tpu_torch import quickstart
    from neural_speech_decoding_tpu_torch.config import FIVE_CLASS_PREFIXES, FilterConfig
    from neural_speech_decoding_tpu_torch.io.dataset import load_trials
    from neural_speech_decoding_tpu_torch.io.export import decoder_params_to_torch_state, save_torch_checkpoint
    from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
    from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
    from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
    from neural_speech_decoding_tpu_torch.tools import eval_models, fidelity_report
    from neural_speech_decoding_tpu_torch.utilities import (
        knight_board_init,
        lstm_eeg_model,
        neurokit_connector,
        preprocessor,
        streaming_process,
        tester,
    )

    runs = []
    t_phase = time.perf_counter()

    def part(fn):
        """fn() with the counts set to 0 before and read after; returns
        (result, launches, seconds to a synchronize)."""
        kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        launches = kernels.launches()
        runs.append(launches)
        return out, launches, s

    def exactly(label, launches, want):
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # 11a. run_trials through the reference import path
        with recorded(InferenceEngine, "predict") as seen:
            result, launches, s = part(lambda: tester.run_trials(
                trials=3, serial_port=SyntheticBoard(speed=64.0), model_path=str(CHECKPOINT), verbose=False))
        exactly("11a utilities.tester.run_trials", launches, {"kuramoto_pair_sums": 3})
        chunks = np.stack([args[1] for args, _ in seen])
        card = np.stack([out[0] for _, out in seen])
        cpu = InferenceEngine(str(CHECKPOINT), class_names=("Food", "Water", "None"), device="cpu").predict_batch(chunks)
        avg = result.avg_probs
        dp = float(np.abs(card - cpu).max())
        if not (result.trials == 3 and len(seen) == 3 and abs(float(avg.sum()) - 1.0) <= 1e-5 and dp <= PROB_TOL
                and float(np.abs(avg - cpu.mean(0)).max()) <= PROB_TOL):
            raise AssertionError(f"11a run_trials: {result}, card vs cpu |dprob| {dp}")
        phase(f"11a utilities.tester.run_trials(3) on SyntheticBoard(speed=64) on {dev}: {s:.3f} s; avg_probs "
              f"{np.round(avg, 4).tolist()} (sum 1); launches {launches}; the 3 decoded windows on the cpu engine: "
              f"|dprob| {dp:.3e} (tol {PROB_TOL})")

        # 11b. SimplePredictor on a .pth written by the port's exporter
        pth = tmp / "lstm3.pth"
        save_torch_checkpoint(pth, decoder_params_to_torch_state(load_params_npz(CHECKPOINT)))
        w16 = synthetic_windows(16, seed=111) * 20.0
        sp = lstm_eeg_model.SimplePredictor(str(pth), sr=125)
        sp_cpu = lstm_eeg_model.SimplePredictor(str(pth), sr=125, device="cpu")
        (probs, labels), launches, s = part(lambda: (
            sp._engine.predict_batch(w16), [sp.predict(w)[1] for w in w16[:3]]))
        # the shim's FilterConfig(lambd=...) is precision "highest": the
        # float64 stages filter on the card, which launches no kernel
        exactly("11b SimplePredictor (highest filter: float64 stages)", launches, {})
        want = sp_cpu._engine.predict_batch(w16)
        dp = float(np.abs(probs - want).max())
        want_labels = [sp_cpu.predict(w)[1] for w in w16[:3]]
        if not (sp._engine.device.type == "cuda" and dp <= PROB_TOL and np.array_equal(probs.argmax(1), want.argmax(1))
                and labels == want_labels):
            raise AssertionError(f"11b SimplePredictor card vs cpu: |dprob| {dp}, labels {labels} vs {want_labels}")
        phase(f"11b SimplePredictor(.pth from the port's exporter, sr 125) on {sp._engine.device}: 16 windows in {s:.3f} s "
              f"(and predict() on 3); launches {launches} (FilterConfig(lambd) is 'highest': float64 stages, no "
              f"kernel); vs cpu |dprob| {dp:.3e} (tol {PROB_TOL}), argmax and labels {labels} equal")

        # 11c. PreProcessor
        pre, pre_cpu = preprocessor.PreProcessor(sr=125), preprocessor.PreProcessor(sr=125, device="cpu")
        out, launches, s = part(lambda: [pre.transform(w) for w in w16[:4]])
        exactly("11c PreProcessor", launches, {})
        rel = max(float(np.abs(g - pre_cpu.transform(w)).max() / np.abs(g).max()) for g, w in zip(out, w16[:4]))
        if not (out[0].dtype == np.float32 and out[0].shape == (T, C) and rel <= SURFACE_FILTER_TOL):
            raise AssertionError(f"11c PreProcessor card vs cpu: {rel}")
        phase(f"11c PreProcessor.transform (4 windows) on {pre.device}: {s:.3f} s; launches {launches}; vs cpu "
              f"{rel:.3e} of each window's max |output| (tol {SURFACE_FILTER_TOL})")

        # 11d. the three board classes on synthetic boards
        t = time.perf_counter()
        conn = neurokit_connector.NeuroPawnConnector(SyntheticBoard(speed=64.0))
        conn.start_stream()
        try:
            drain(conn.board, T)
            win = conn.get_window(5.0)
        finally:
            conn.stop_stream()
        board = SyntheticBoard(speed=64.0)
        sent, send = [], board.config_board_with_bytes
        board.config_board_with_bytes = lambda payload: sent.append((payload.decode(), board._streaming)) or send(payload)
        kb = knight_board_init.KnightBoard(board, 8)
        try:
            kb.get_window(5.0)
            raise AssertionError("11d KnightBoard.get_window before start_stream did not raise")
        except RuntimeError:
            pass
        kb.start_stream()
        try:
            drain(board, T)
            kwin = kb.get_window(5.0)
        finally:
            kb.stop_stream()
        q = queue.Queue(maxsize=8)
        proc = streaming_process.StreamingProcess(SyntheticBoard(speed=64.0), out_queue=q)
        proc.start()
        proc.recording_flag.value = True
        try:
            payloads = [q.get(timeout=30) for _ in range(2)]
        finally:
            proc.recording_flag.value = False
            proc.stop()
            proc.join(timeout=5)
        if not (conn.params is None and win.shape == (C, T) and kwin.shape == (C, T) and kb.board_shim is board
                and sent == [(c, True) for c in LEGACY_COMMANDS]
                and all(p["data"].shape == (T, C) and p["sr"] == 125 for p in payloads)):
            raise AssertionError(f"11d boards: windows {win.shape} {kwin.shape}, commands {sent}")
        phase(f"11d NeuroPawnConnector window {win.shape}; KnightBoard window {kwin.shape}, {len(sent)} config "
              f"commands after start_stream in the legacy order; StreamingProcess {len(payloads)} payloads of "
              f"{payloads[0]['data'].shape} at sr {payloads[0]['sr']}: {time.perf_counter() - t:.3f} s")

        # 11e. eval_models on synthetic trials
        trials = tmp / "trials"
        trials.mkdir()
        write_trials(trials, SURFACE_TRIALS, seed=112)
        results, launches, s = part(lambda: eval_models.evaluate_all(trials, reference=str(pth)))
        exactly("11e eval_models (the 3-class split filtered once)", launches, {"kuramoto_pair_sums": 1})
        cpu_results = eval_models.evaluate_all(trials, reference=str(pth), device="cpu")
        _, val = load_trials(trials).split(0.2, seed=0)
        worst = max(abs(results[k] - cpu_results[k]) for k in cpu_results)
        if not (list(results) == list(cpu_results) and eval_models.REFERENCE_KEY in results
                and all(0.0 <= v <= 1.0 for v in results.values()) and worst <= 1.0 / len(val)):
            raise AssertionError(f"11e eval_models: {results} vs cpu {cpu_results}")
        phase(f"11e eval_models({SURFACE_TRIALS} trials, {len(val)} held out, --reference) on {dev}: {s:.3f} s; "
              f"{len(results)} rows, accuracies {[round(v, 3) for v in results.values()]}; launches {launches}; "
              f"vs cpu at most {worst:.3f} apart (tol one window, {1.0 / len(val):.3f})")

        # 11f. the fidelity report against a golden dump of the CPU engine in float64
        ds = load_trials(trials, class_prefixes=FIVE_CLASS_PREFIXES)
        cpu_params = params_from_jax(load_params_npz(CHECKPOINT), "cpu")
        logits = decoder_logits(cpu_params, mai_filter_batch(ds.windows, FilterConfig(precision="highest"),
                                                             device="cpu")).numpy()
        golden, golden_filtered = tmp / "golden_probs.npz", tmp / "golden_filtered.npz"
        np.savez(golden, files=np.asarray(ds.files), logits=logits,
                 probs=torch.softmax(torch.from_numpy(logits), -1).numpy())
        with contextlib.redirect_stdout(sys.stderr):
            fidelity_report.write_filtered(ds, golden_filtered)
        with contextlib.redirect_stdout(sys.stderr):
            report, launches, s = part(lambda: fidelity_report.fidelity_report(
                pth, trials, golden, golden_filtered, stages=True))
        exactly("11f fidelity_report (fast and turbo each filter once)", launches, {"kuramoto_pair_sums": 2})
        modes = report["modes"]
        if not (list(modes) == ["fidelity f64", "fast f32", "turbo bf16"]
                and modes["fidelity f64"]["max_dlogit"] <= LOGIT_TOL
                and modes["fidelity f64"]["argmax_agreement"] == 1.0
                and all(np.isfinite(v) for m in modes.values() for v in m.values())):
            raise AssertionError(f"11f fidelity_report: {report}")
        phase(f"11f fidelity_report --stages ({report['trials']} trials, lstm3 .pth) on {report['device']}: "
              f"{s:.3f} s; launches {launches}; against the cpu engine's float64 golden dump (highest mode tol "
              f"{LOGIT_TOL} |dlogit|): " + "; ".join(
                  f"{name}: |dlogit| {m['max_dlogit']:.3e}, |dprob| {m['max_dprob']:.3e}, argmax "
                  f"{m['argmax_agreement']:.4f}, filter {m['filter_max_delta']:.3e}, model-only "
                  f"{m['model_only_max_dlogit']:.3e}" for name, m in modes.items()))

        # 11g. the quickstart on those trials
        with contextlib.redirect_stdout(sys.stderr):
            qs, launches, s = part(lambda: quickstart.run(trials))
        if min(launches[k] for k in PATH_KERNELS) < 1 or launches["kuramoto_pair_sums"] < 13:
            raise AssertionError(f"11g quickstart left a kernel of its path unlaunched: {launches}")
        ds3 = load_trials(trials)
        want = InferenceEngine(str(CHECKPOINT), device="cpu").predict_batch(ds3.windows[:16])
        ewant = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu").predict_batch(ds3.windows[:16])
        dp = float(np.abs(qs["batch_probs"] - want).max())
        dpe = float(np.abs(qs["ensemble_probs"] - ewant).max())
        if not (dp <= PROB_TOL and dpe <= PROB_TOL and qs["run_trials"].trials == 5
                and qs["stream_predictions"] == 5 and qs["recording_windows"] == 11):
            raise AssertionError(f"11g quickstart: batch |dprob| {dp}, ensemble |dprob| {dpe}, {qs}")
        phase(f"11g quickstart on {SURFACE_TRIALS} trials on {dev}: {s:.3f} s; launches {launches}; batched decode "
              f"(16) vs cpu |dprob| {dp:.3e}, ensemble (16) vs cpu |dprob| {dpe:.3e} (tol {PROB_TOL}); run_trials "
              f"5, stream 5 predictions, recording {qs['recording_windows']} windows")

    # 11h. entry.py: entry()'s forward, and dryrun_multichip(2)
    fn, (params, windows) = port_entry.entry()
    probs, launches, s = part(lambda: fn(params, windows))
    exactly("11h entry forward", launches, {"kuramoto_pair_sums": 1})
    cfn, (cparams, cwindows) = port_entry.entry(device="cpu")
    dp = float(np.abs(probs.cpu().numpy() - cfn(cparams, cwindows).numpy()).max())
    if not (probs.device.type == "cuda" and probs.shape == (8, 3) and dp <= PROB_TOL):
        raise AssertionError(f"11h entry forward card vs cpu: |dprob| {dp}")
    devices = mesh_devices(2)
    with contextlib.redirect_stdout(sys.stderr):
        dry, dlaunches, dry_s = part(lambda: port_entry.dryrun_multichip(2, devices=devices))
    if min(dlaunches[k] for k in PATH_KERNELS) < 2 or dry["ensemble_members"] != 5:
        raise AssertionError(f"11h dryrun_multichip: {dry}, launches {dlaunches}")
    phase(f"11h entry() forward (8 windows) on {dev}: {s:.3f} s; launches {launches}; vs cpu |dprob| {dp:.3e} "
          f"(tol {PROB_TOL}); dryrun_multichip(2) on {devices}: {dry_s:.3f} s; lstm loss {dry['loss']:.4f}, logcov8 "
          f"loss {dry['logcov8_loss']:.4f}, {dry['ensemble_members']} members served, sharded filter vs stages "
          f"{dry['kernel_vs_stages_max_delta']:.3e}; launches {dlaunches}")
    phase(f"11 phase 11 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kernels import build
    from neural_speech_decoding_tpu_torch.ops.kernels import kuramoto as ku
    from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
        fft_plan,
        kuramoto_pair_sums,
        kuramoto_pair_sums_plain,
    )
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import (
        band_grams,
        band_grams_plain,
    )
    from neural_speech_decoding_tpu_torch.ops.kernels.logmfeats import (
        logcov_feats,
        logcov_feats_plain,
    )
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
    from neural_speech_decoding_tpu_torch.runtime.tester import run_trials, run_trials_ex

    torch.set_num_threads(1)  # the CPU comparison runs tiny eager ops
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' products in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    logs = build.build(sorted(set(kernels.SOURCES.values())))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                phase(f"build {name}: {line.strip()}")
    phase(f"built {sorted(set(kernels.SOURCES.values()))} ({len(logs)} compiled now)")

    # 3. kernel against its plain twin
    max_err = 0.0
    times = {}
    device_jobs = {}  # label -> a call whose device-only time is measured after phase 9
    for b in BATCHES:
        x = pair_sums_inputs(b, seed=b, device=dev)
        got = kuramoto_pair_sums(x)
        want = kuramoto_pair_sums_plain(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= PAIR_SUMS_ABS_TOL):
            raise AssertionError(f"pair sums B={b}: max abs err {err} > {PAIR_SUMS_ABS_TOL}")
        if not torch.equal(got, got.transpose(1, 2)) or got[0, 3, 3].item() != float(T):
            raise AssertionError(f"pair sums B={b}: not symmetric or dead channel != T")
        max_err = max(max_err, err)
        exact = kuramoto_pair_sums_plain(x.double())  # the same sums in float64
        k64 = (got.double() - exact).abs()
        p64 = (want.double() - exact).abs()
        ratio = k64.max().item() / p64.max().item()
        if not ratio <= F64_RATIO:
            raise AssertionError(f"pair sums B={b}: {ratio:.2f}x the twin's error against float64 > {F64_RATIO}")
        line = (f"pair sums B={b}: max abs err {err:.3e} (tol {PAIR_SUMS_ABS_TOL}); "
                f"vs float64: kernel max {k64.max().item():.3e} mean {k64.mean().item():.3e}, "
                f"twin max {p64.max().item():.3e} mean {p64.mean().item():.3e} "
                f"(kernel / twin {ratio:.2f}, limit {F64_RATIO})")
        del exact, k64, p64
        if b in TIMED:
            k_ms = cuda_ms(lambda: kuramoto_pair_sums(x), 20)
            p_ms = cuda_ms(lambda: kuramoto_pair_sums_plain(x), 10)
            bound, by = pair_sums_bound_ms(b)
            times[b] = (k_ms, p_ms, bound, by)
            line += f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by})"
            if b == TIMED[0]:
                device_jobs["kuramoto_pair_sums"] = functools.partial(kuramoto_pair_sums, x)
        phase(line)
        del x, got, want

    # 3 (continued). the pair sums at other window lengths: a prime (the
    # direct-DFT stage) and 10 s at 125 Hz (radices 2 and 5)
    for t_len in OTHER_T:
        for b in (1, 37):
            x = pair_sums_inputs(b, seed=b + t_len, device=dev, t_len=t_len)
            got = kuramoto_pair_sums(x)
            want = kuramoto_pair_sums_plain(x)
            exact = kuramoto_pair_sums_plain(x.double())
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (torch.isfinite(got).all() and err <= PAIR_SUMS_ABS_TOL):
                raise AssertionError(f"pair sums T={t_len} B={b}: max abs err {err} > {PAIR_SUMS_ABS_TOL}")
            if not torch.equal(got, got.transpose(1, 2)) or got[0, 3, 3].item() != float(t_len):
                raise AssertionError(f"pair sums T={t_len} B={b}: not symmetric or dead channel != T")
            k64 = (got.double() - exact).abs().max().item()
            p64 = (want.double() - exact).abs().max().item()
            if not k64 <= F64_RATIO * p64:
                raise AssertionError(f"pair sums T={t_len} B={b}: {k64 / p64:.2f}x the twin's error "
                                     f"against float64 > {F64_RATIO}")
            max_err = max(max_err, err)
            phase(f"pair sums T={t_len} B={b} (radices {fft_plan(t_len)}): max abs err {err:.3e} "
                  f"(tol {PAIR_SUMS_ABS_TOL}); vs float64: kernel max {k64:.3e}, twin max {p64:.3e} "
                  f"(kernel / twin {k64 / p64:.2f}, limit {F64_RATIO})")
            del x, got, want, exact

    # 3 (continued). the pair sums' data-dependent cost: windows with
    # burst channels (hundreds of near-zero samples a block) and
    # board-like windows, against the twin and timed beside the Gaussian
    # windows' time above
    refine = ku.refine_below()
    kinds = (("burst", burst_windows), ("all-channel burst", lambda b, seed: burst_windows(b, seed, tuple(range(C)))),
             ("board-like", synthetic_windows))
    for name, make in kinds:
        for b in TIMED:
            x = torch.from_numpy(make(b, seed=b + 5)).to(dev)
            got = kuramoto_pair_sums(x)
            want = kuramoto_pair_sums_plain(x)
            exact = kuramoto_pair_sums_plain(x.double())
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            k64 = (got.double() - exact).abs().max().item()
            p64 = (want.double() - exact).abs().max().item()
            if not (torch.isfinite(got).all() and err <= PAIR_SUMS_ABS_TOL and torch.equal(got, got.transpose(1, 2))):
                raise AssertionError(f"pair sums, {name} windows B={b}: max abs err {err} > {PAIR_SUMS_ABS_TOL} "
                                     "or not symmetric")
            if not k64 <= F64_RATIO * p64:
                raise AssertionError(f"pair sums, {name} windows B={b}: {k64 / p64:.2f}x the twin's error "
                                     f"against float64 > {F64_RATIO}")
            max_err = max(max_err, err)
            queued = near_zero_per_block(x, refine)
            k_ms = cuda_ms(lambda: kuramoto_pair_sums(x), 20)
            phase(f"pair sums, {name} windows B={b}: max abs err {err:.3e} (tol {PAIR_SUMS_ABS_TOL}); vs "
                  f"float64: kernel {k64:.3e}, twin {p64:.3e} (kernel / twin {k64 / p64:.2f}); near-zero "
                  f"samples a 2-window block (|z|^2 < {refine:g} of the series' mean x^2): mean "
                  f"{queued.mean():.1f}, max {int(queued.max())}; kernel {k_ms:.4f} ms "
                  f"(Gaussian windows: {times[b][0]:.4f} ms)")
            del x, got, want, exact

    # 3 (continued). the flagship's two kernels against their twins
    phase(f"band grams kernel: {kernel_resources(logs.get('bandcov_grams'), 'band_grams_kernel')}")
    gram_err = feat_err = 0.0
    logcov_times, gram_times = {}, {}
    for b in BATCHES:
        k = logcov_kernel_inputs(b, seed=b + 1, dev=dev)
        got = band_grams(k.yw, k.offsets)
        want = band_grams_plain(k.yw, k.offsets)
        exact = band_grams_plain(k.yw.double(), k.offsets)
        torch.cuda.synchronize()
        norm = exact.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)  # each window's max|G|
        err = ((got - want).abs() / norm).max().item()
        if not (torch.isfinite(got).all() and err <= BAND_GRAMS_REL_TOL):
            raise AssertionError(f"band grams B={b}: max err {err} of max|G| > {BAND_GRAMS_REL_TOL}")
        gram_err = max(gram_err, err)
        k64 = ((got.double() - exact).abs() / norm).max().item()
        p64 = ((want.double() - exact).abs() / norm).max().item()
        if not k64 <= BAND_GRAMS_F64_TOL:
            raise AssertionError(f"band grams B={b}: {k64} of max|G| against float64 > {BAND_GRAMS_F64_TOL}")
        line = (f"band grams B={b}: max err {err:.3e} of each window's max|G| (tol {BAND_GRAMS_REL_TOL}); "
                f"vs float64: kernel {k64:.3e} (tol {BAND_GRAMS_F64_TOL}), twin {p64:.3e}")
        del exact
        if b in GRAM_TIMED:
            gram_times[b] = time_band_grams(k.yw, k.offsets, device_jobs)
            line += "; " + gram_times[b][-1]

        # the feature kernel, on the gram kernel's output (its input on the path)
        feats, flags = logcov_feats(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
        want_f, want_flags = logcov_feats_plain(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
        exact_f, exact_flags = logcov_feats_plain(
            got.double(), k.tr_scaled.double(), k.wwt_pairs.double(), k.coeffs, **k.scalars
        )
        torch.cuda.synchronize()
        fdiff = (feats - want_f).abs()
        fnorm = want_f.abs().amax(dim=1, keepdim=True).clamp(min=1.0)  # each window's max(scale, 1)
        ferr = (fdiff / fnorm).max().item()
        if not (torch.isfinite(feats).all() and ferr <= LOGCOV_FEATS_TOL):
            raise AssertionError(f"logcov feats B={b}: max err {ferr} of max(scale, 1) > {LOGCOV_FEATS_TOL}")
        if not torch.equal(flags, want_flags):
            raise AssertionError(f"logcov feats B={b}: guard flags differ from the twin's")
        k64 = (feats.double() - exact_f).abs().max().item()
        p64 = (want_f.double() - exact_f).abs().max().item()
        if not k64 <= F64_RATIO * p64:
            raise AssertionError(f"logcov feats B={b}: {k64 / p64:.2f}x the twin's error against float64 "
                                 f"> {F64_RATIO}")
        if b >= 3 and not (flags[0].all() and flags[2].any() and not flags.all()):
            raise AssertionError(f"logcov feats B={b}: the guard did not fire as the inputs demand")
        feat_err = max(feat_err, fdiff.max().item())
        line2 = (f"logcov feats B={b}: max err {ferr:.3e} of each window's max(scale, 1) "
                 f"(tol {LOGCOV_FEATS_TOL}; largest scale {fnorm.max().item():.3f}), "
                 f"max abs err {fdiff.max().item():.3e}; "
                 f"flags equal ({int(flags.sum())} of {flags.numel()} set); vs float64: kernel max "
                 f"{k64:.3e}, twin max {p64:.3e} (kernel / twin {k64 / p64:.2f}, limit {F64_RATIO}), "
                 f"float64 flags differ in {int((exact_flags != flags).sum())}")
        del exact_f, exact_flags, fdiff
        if b in TIMED:
            nb = len(k.offsets) - 1
            f_ms = cuda_ms(lambda: logcov_feats(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars), 20)
            fp_ms = cuda_ms(lambda: logcov_feats_plain(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars), 3)
            f_bound, f_by = logcov_feats_bound_ms(b, nb, (len(k.coeffs) - 1) // 2)
            logcov_times[b] = {
                "bandcov_grams": gram_times[b][:5],
                "logcov_feats": (f_ms, fp_ms, f_bound, f_by, None),
            }
            line2 += f"; kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms, bound {f_bound:.4f} ms ({f_by})"
            if b == TIMED[0]:
                device_jobs["logcov_feats"] = functools.partial(
                    logcov_feats, got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars)
        phase(line)
        phase(line2)
        del k, got, want, feats, flags, want_f, want_flags

    # 3 (continued). the band grams on the other layouts
    gram_err = max(gram_err, check_gram_layouts(dev))

    # 3c. the slice-3 kernels against their twins
    cheb_err, cheb_times = check_chebyshev_feats(dev, logs.get("logcov_feats"), device_jobs)
    logm_err, logm_times = check_clenshaw(dev, logs.get("logm_clenshaw"), device_jobs)
    iir_err, iir_times = check_iir(dev, logs.get("iir_cascade"), device_jobs)

    # 4. the main path
    engine = InferenceEngine(model_path=str(CHECKPOINT))
    windows = synthetic_windows(1024, seed=0)
    kernels.reset_launches()
    t = time.perf_counter()
    probs = engine.predict_batch(windows)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    main_launches = kernels.launches()
    if main_launches["kuramoto_pair_sums"] < 1:
        raise AssertionError(f"predict_batch launched no pair-sums kernel: {main_launches}")
    if probs.shape != (1024, 3) or not np.isfinite(probs).all():
        raise AssertionError(f"predict_batch: bad probabilities {probs.shape}")
    if np.abs(probs.sum(axis=1) - 1.0).max() > 1e-5:
        raise AssertionError("predict_batch: probabilities do not sum to 1")
    phase(f"predict_batch(1024) on {dev}: {cold_s:.3f} s first call; launches {main_launches}; "
          f"argmax counts {np.bincount(probs.argmax(1), minlength=3).tolist()}")
    xw = torch.from_numpy(windows).to(dev)
    f_ms = cuda_ms(lambda: mai_filter_batch(xw, engine.config.filter, device=dev), 5)
    filtered = mai_filter_batch(xw, engine.config.filter, device=dev)
    d_ms = cuda_ms(lambda: decoder_logits(engine.params, filtered, engine.config.decoder), 2)
    w_ms = cuda_ms(lambda: engine.predict_batch(windows), 2)
    phase(f"predict_batch(1024) warm {w_ms:.3f} ms = filter {f_ms:.3f} ms + LSTM/head {d_ms:.3f} ms + host")

    w16 = windows[:16]
    gpu_logits = engine.logits_batch(w16)
    cpu_logits = InferenceEngine(model_path=str(CHECKPOINT), device="cpu").logits_batch(w16)
    dlogit = float(np.abs(gpu_logits - cpu_logits).max())
    if not dlogit <= LOGIT_TOL:
        raise AssertionError(f"cuda vs cpu engine: max |delta logit| {dlogit} > {LOGIT_TOL}")
    phase(f"engine cuda vs cpu, 16 windows: max |delta logit| {dlogit:.3e} (tol {LOGIT_TOL})")

    # 4b. the flagship path: the whitened logcov8 seed ensemble
    flagship = EnsembleEngine.from_manifest(str(FLAGSHIP))
    kernels.reset_launches()
    t = time.perf_counter()
    fprobs = flagship.predict_batch(windows)
    torch.cuda.synchronize()
    f_cold_s = time.perf_counter() - t
    flagship_launches = kernels.launches()
    if min(flagship_launches[n] for n in ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats")) < 1:
        raise AssertionError(f"the flagship path left a kernel unlaunched: {flagship_launches}")
    if fprobs.shape != (1024, 3) or not np.isfinite(fprobs).all():
        raise AssertionError(f"flagship predict_batch: bad probabilities {fprobs.shape}")
    if np.abs(fprobs.sum(axis=1) - 1.0).max() > 1e-5:
        raise AssertionError("flagship predict_batch: probabilities do not sum to 1")
    phase(f"flagship predict_batch(1024) on {dev}: {f_cold_s:.3f} s first call; {flagship.num_members} "
          f"members, shared features {flagship._shared_featurize}; launches {flagship_launches}; "
          f"argmax counts {np.bincount(fprobs.argmax(1), minlength=3).tolist()}; stats {flagship.stats}")
    ff_ms = cuda_ms(lambda: mai_filter_batch(xw, flagship.config.filter, device=dev), 5)
    ffiltered = mai_filter_batch(xw, flagship.config.filter, device=dev)
    fx_ms = cuda_ms(lambda: flagship.featurize(ffiltered), 10)
    ffeats, _ = flagship.featurize(ffiltered)
    fh_ms = cuda_ms(lambda: flagship.heads(ffeats), 10)
    fw_ms = cuda_ms(lambda: flagship.predict_batch(windows), 5)
    phase(f"flagship predict_batch(1024) warm {fw_ms:.3f} ms = filter {ff_ms:.3f} ms + features "
          f"{fx_ms:.3f} ms + heads {fh_ms:.3f} ms + host")

    w16 = windows[:16].copy()
    w16[5] = 0.0  # an all-zero window
    before = flagship.stats
    gpu_probs = flagship.predict_batch(w16)
    gpu_flagged = flagship.stats["guard_flagged"] - before["guard_flagged"]
    gpu_logits = flagship.logits_batch(w16)
    cpu_flagship = EnsembleEngine.from_manifest(str(FLAGSHIP), device="cpu")
    cpu_probs = cpu_flagship.predict_batch(w16)
    cpu_flagged = cpu_flagship.stats["guard_flagged"]
    cpu_logits = cpu_flagship.logits_batch(w16)
    dprob = float(np.abs(gpu_probs - cpu_probs).max())
    dlogit = float(np.abs(gpu_logits - cpu_logits).max())
    if not (dprob <= PROB_TOL and dlogit <= LOGIT_TOL and gpu_flagged == cpu_flagged):
        raise AssertionError(f"flagship cuda vs cpu: |dprob| {dprob}, |dlogit| {dlogit}, "
                             f"guard counts {gpu_flagged} vs {cpu_flagged}")
    phase(f"flagship cuda vs cpu, 16 windows: max |delta prob| {dprob:.3e} (tol {PROB_TOL}), "
          f"max |delta logit| {dlogit:.3e} over {gpu_logits.shape[0]} members (tol {LOGIT_TOL}); "
          f"guard_flagged {gpu_flagged} = {cpu_flagged}")
    del cpu_flagship

    # 5. run_trials under a deadline
    def _deadline(signum, frame):
        raise TimeoutError(f"run_trials passed its {RUN_TRIALS_DEADLINE_S} s deadline")

    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(RUN_TRIALS_DEADLINE_S)
    try:
        kernels.reset_launches()
        result = run_trials(
            trials=3,
            serial_port=SyntheticBoard(speed=64.0),
            model_path=str(CHECKPOINT),
            verbose=False,
        )
        torch.cuda.synchronize()
        trial_launches = kernels.launches()
    finally:
        signal.alarm(0)
    if trial_launches["kuramoto_pair_sums"] < 3:
        raise AssertionError(f"run_trials launched the pair-sums kernel too rarely: {trial_launches}")
    avg = result.avg_probs
    if result.trials != 3 or avg is None or avg.shape != (3,) or not np.isfinite(avg).all():
        raise AssertionError(f"run_trials: bad result {result}")
    if abs(float(avg.sum()) - 1.0) > 1e-5:
        raise AssertionError("run_trials: averaged probabilities do not sum to 1")
    phase(f"run_trials(3) on SyntheticBoard(speed=64): avg_probs {np.round(avg, 4).tolist()}; "
          f"launches {trial_launches}")

    # 5b. the flagship engine under run_trials_ex, same deadline
    signal.alarm(RUN_TRIALS_DEADLINE_S)
    try:
        kernels.reset_launches()
        fresult, _ = run_trials_ex(
            trials=3,
            serial_port=SyntheticBoard(speed=64.0),
            verbose=False,
            engine=flagship,
        )
        torch.cuda.synchronize()
        flagship_trial_launches = kernels.launches()
    finally:
        signal.alarm(0)
    if min(flagship_trial_launches[n] for n in ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats")) < 3:
        raise AssertionError(f"flagship run_trials launched a kernel too rarely: {flagship_trial_launches}")
    favg = fresult.avg_probs
    if fresult.trials != 3 or favg is None or favg.shape != (3,) or not np.isfinite(favg).all():
        raise AssertionError(f"flagship run_trials: bad result {fresult}")
    if abs(float(favg.sum()) - 1.0) > 1e-5:
        raise AssertionError("flagship run_trials: averaged probabilities do not sum to 1")
    phase(f"flagship run_trials_ex(3) on SyntheticBoard(speed=64): avg_probs {np.round(favg, 4).tolist()}; "
          f"launches {flagship_trial_launches}")

    # 4c. the flagship served with the Chebyshev matrix log
    cheb = EnsembleEngine.from_manifest(str(FLAGSHIP), model_kw=CHEB_KW)
    kernels.reset_launches()
    t = time.perf_counter()
    cprobs = cheb.predict_batch(windows)
    torch.cuda.synchronize()
    c_cold_s = time.perf_counter() - t
    cheb_launches = kernels.launches()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(kuramoto_pair_sums=1, bandcov_grams=1, logcov_feats_chebyshev=1)
    if cheb_launches != want:
        raise AssertionError(f"chebyshev flagship predict_batch: launches {cheb_launches}, want {want}")
    if cprobs.shape != (1024, 3) or not np.isfinite(cprobs).all() or np.abs(cprobs.sum(1) - 1).max() > 1e-5:
        raise AssertionError("chebyshev flagship predict_batch: bad probabilities")
    agree = float((cprobs.argmax(1) == fprobs.argmax(1)).mean())
    phase(f"chebyshev flagship predict_batch(1024) on {dev}: {c_cold_s:.3f} s first call; launches "
          f"{cheb_launches}; argmax counts {np.bincount(cprobs.argmax(1), minlength=3).tolist()}, "
          f"argmax equal to the rational flagship's on {agree:.4f} of the windows, max |delta prob| "
          f"{np.abs(cprobs - fprobs).max():.3e}")
    cx_ms = cuda_ms(lambda: cheb.featurize(ffiltered), 10)
    cw_ms = cuda_ms(lambda: cheb.predict_batch(windows), 5)
    phase(f"chebyshev flagship predict_batch(1024) warm {cw_ms:.3f} ms; features {cx_ms:.3f} ms")

    def card_vs_cpu(engine_gpu, manifest, model_kw, label):
        before = engine_gpu.stats
        gpu_probs = engine_gpu.predict_batch(w16)
        gpu_flagged = engine_gpu.stats["guard_flagged"] - before["guard_flagged"]
        cpu_engine = EnsembleEngine.from_manifest(str(manifest), model_kw=model_kw, device="cpu")
        cpu_probs = cpu_engine.predict_batch(w16)
        dp = float(np.abs(gpu_probs - cpu_probs).max())
        if not (dp <= PROB_TOL and np.array_equal(gpu_probs.argmax(1), cpu_probs.argmax(1))
                and gpu_flagged == cpu_engine.stats["guard_flagged"]):
            raise AssertionError(f"{label} cuda vs cpu: |dprob| {dp}, guard counts "
                                 f"{gpu_flagged} vs {cpu_engine.stats['guard_flagged']}")
        phase(f"{label} cuda vs cpu, 16 windows: max |delta prob| {dp:.3e} (tol {PROB_TOL}), argmax "
              f"equal; guard_flagged {gpu_flagged} = {cpu_engine.stats['guard_flagged']}")

    card_vs_cpu(cheb, FLAGSHIP, CHEB_KW, "chebyshev flagship")

    # 5c. the Chebyshev flagship under run_trials_ex
    signal.alarm(RUN_TRIALS_DEADLINE_S)
    try:
        kernels.reset_launches()
        cresult, _ = run_trials_ex(trials=3, serial_port=SyntheticBoard(speed=64.0), verbose=False, engine=cheb)
        torch.cuda.synchronize()
        cheb_trial_launches = kernels.launches()
    finally:
        signal.alarm(0)
    if min(cheb_trial_launches[n] for n in ("bandcov_grams", "logcov_feats_chebyshev")) < 3:
        raise AssertionError(f"chebyshev run_trials launched a kernel too rarely: {cheb_trial_launches}")
    cavg = cresult.avg_probs
    if cresult.trials != 3 or cavg is None or cavg.shape != (3,) or abs(float(cavg.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"chebyshev run_trials: bad result {cresult}")
    phase(f"chebyshev flagship run_trials_ex(3) on SyntheticBoard(speed=64): avg_probs "
          f"{np.round(cavg, 4).tolist()}; launches {cheb_trial_launches}")

    # 4d. the unwhitened ensemble with the Chebyshev log: the stages path
    unw = EnsembleEngine.from_manifest(str(UNWHITENED), model_kw={"logm": "chebyshev"})
    kernels.reset_launches()
    t = time.perf_counter()
    uprobs = unw.predict_batch(windows)
    torch.cuda.synchronize()
    u_cold_s = time.perf_counter() - t
    unw_launches = kernels.launches()
    if unw_launches["logm_clenshaw"] < 1 or unw_launches["logcov_feats_chebyshev"] or unw_launches["logcov_feats"]:
        raise AssertionError(f"unwhitened chebyshev predict_batch: launches {unw_launches}")
    if uprobs.shape != (1024, 3) or not np.isfinite(uprobs).all() or np.abs(uprobs.sum(1) - 1).max() > 1e-5:
        raise AssertionError("unwhitened chebyshev predict_batch: bad probabilities")
    uw_ms = cuda_ms(lambda: unw.predict_batch(windows), 5)
    phase(f"unwhitened logcov8_ens chebyshev predict_batch(1024) on {dev}: {u_cold_s:.3f} s first call, "
          f"warm {uw_ms:.3f} ms; {unw.num_members} members, shared features {unw._shared_featurize}; "
          f"launches {unw_launches}; argmax counts {np.bincount(uprobs.argmax(1), minlength=3).tolist()}")
    card_vs_cpu(unw, UNWHITENED, {"logm": "chebyshev"}, "unwhitened chebyshev")

    # 4e. the fused zero-phase preprocessing of board-like windows
    from neural_speech_decoding_tpu_torch.ops.kernels.iir import collector_stages, fused_preprocess, stack_sos

    stages = collector_stages()
    kernels.reset_launches()
    pre = fused_preprocess(windows, stages)
    torch.cuda.synchronize()
    iir_launches = kernels.launches()
    if iir_launches["iir_cascade"] != 1 or pre.shape != windows.shape or not torch.isfinite(pre).all():
        raise AssertionError(f"fused_preprocess: launches {iir_launches}, shape {tuple(pre.shape)}")
    xd = windows.astype(np.float64)
    ref = scipy_zero_phase(xd - xd.mean(axis=1, keepdims=True), stack_sos(stages))
    pre_err = float((np.abs(pre.cpu().numpy() - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)).max())
    if not pre_err <= IIR_SCIPY_TOL:
        raise AssertionError(f"fused_preprocess vs scipy float64: {pre_err} of scale > {IIR_SCIPY_TOL}")
    pw_ms = cuda_ms(lambda: fused_preprocess(windows, stages), 5)
    phase(f"fused_preprocess(1024, collector_stages) on {dev}: {pre_err:.3e} of each window's scale vs "
          f"scipy float64 (tol {IIR_SCIPY_TOL}); warm {pw_ms:.3f} ms with the host copy; launches {iir_launches}")

    # 4f-4h, 5d. the other families, a mixed ensemble, a recording
    family_launches = check_families(dev, windows)
    mix_launches = check_mixed(dev, windows, w16)
    rec_launches = check_recording(dev)
    tcn_trial_launches = check_tcn_trials()

    # 7. training on the card
    train_launches = train_flagship(dev, windows[:16], smi)
    cli_launches = train_cli(dev, windows[:16])
    check_gradients(dev, smi)

    # 8. the live path: boards, stream, collector, dashboard
    live_launches = check_live_path(dev, smi)

    # 9. the analysis and evaluation path: analysis, tools, tracing
    analysis_launches = check_analysis_path(dev, smi, flagship)

    # 10. data parallelism on a one-process mesh
    mesh_launches = check_mesh_path(dev, smi, windows, probs, flagship, fprobs)

    # 3d. the device-only times of phase 3's calls, measured here and not
    # in phase 3: with these torch.profiler sessions in phase 3, 9g's
    # trace was seen to hold no pair-sums kernel event in its range (H100,
    # torch 2.11), so 9g keeps the process's first session. And before
    # phase 11: after it, the first of these sessions was seen to record
    # no kernel at all (H100, torch 2.11), though no part of phase 11 alone
    # did that to a session that followed it in a fresh process
    device_only = {label: device_ms(fn, 20) for label, fn in device_jobs.items()}
    del device_jobs

    # 11. the reference surface, the evaluation and fidelity tools, the
    # quickstart and entry.py
    surface_launches = check_reference_surface(dev, smi)

    # 6. report
    k_ms, p_ms, bound, by = times[TIMED[-1]]
    phase(f"kernel times below are at B={TIMED[-1]} (batch {TIMED[0]}: kernel {times[TIMED[0]][0]:.4f} ms, "
          f"plain {times[TIMED[0]][1]:.4f} ms, bound {times[TIMED[0]][2]:.4f} ms)")
    def launched(name):
        return sum(run[name] for run in [main_launches, trial_launches, flagship_launches,
                                         flagship_trial_launches, cheb_launches, cheb_trial_launches,
                                         unw_launches, iir_launches, mix_launches, rec_launches,
                                         tcn_trial_launches, train_launches, cli_launches]
                   + family_launches + live_launches + analysis_launches + mesh_launches + surface_launches)

    logcov_times[TIMED[0]].update(logcov_feats_chebyshev=cheb_times[TIMED[0]], logm_clenshaw=logm_times[TIMED[0]],
                              iir_cascade=iir_times[TIMED[0]])
    logcov_times[TIMED[-1]].update(logcov_feats_chebyshev=cheb_times[TIMED[-1]], logm_clenshaw=logm_times[TIMED[-1]],
                               iir_cascade=iir_times[TIMED[-1]])
    at_first = dict(kuramoto_pair_sums=times[TIMED[0]] + (None,), **logcov_times[TIMED[0]])
    for name, g in at_first.items():
        dev_ms, per_call, names = device_only[name if name != "bandcov_grams" else f"{name} B={TIMED[0]}"]
        phase(f"{name} at B={TIMED[0]}: kernel {g[0]:.4f} ms (call mean), device-only {dev_ms:.4f} ms "
              f"({per_call:.3g} kernel events a call: {', '.join(names)}), plain {g[1]:.4f} ms, bound "
              f"{g[2]:.4f} ms" + ("" if g[4] is None else f", library {g[4]:.4f} ms") + f" ({smi})")
    for b, g in gram_times.items():
        k_dev, l_dev = device_only[f"bandcov_grams B={b}"], device_only[f"library B={b}"]
        phase(f"bandcov_grams at B={b}: call mean {g[0]:.4f} ms, device-only {k_dev[0]:.4f} ms ({k_dev[1]:.3g} "
              f"kernel events a call); library call mean {g[4]:.4f} ms, device-only {l_dev[0]:.4f} ms "
              f"({l_dev[1]:.3g} kernel events a call: {', '.join(l_dev[2])}); plain {g[1]:.4f} ms; bound "
              f"{g[2]:.4f} ms ({g[3]}); {smi}")
    report = {
        "kernels": [
            {
                "name": "kuramoto_pair_sums",
                "route": "cuda",
                "source": "neural_speech_decoding_tpu_torch/csrc/kuramoto_pair_sums.cu",
                "replaces": "neural_speech_decoding_tpu/ops/pallas/kuramoto.py:60",
                "launches": launched("kuramoto_pair_sums"),
                "max_abs_err": max_err,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,
            },
        ]
    }
    # max_abs_err of bandcov_grams is taken on each window's pairs over
    # that window's max|G|, the quantity its limit bounds; that of
    # logcov_feats is the plain largest |kernel - twin| (its limit is on
    # the same difference over each window's max(scale, 1))
    # logcov_feats_chebyshev, logm_clenshaw and iir_cascade report the
    # plain largest |kernel - twin|; logm_clenshaw's library_ms is the
    # eigh route (the exact log), the only PyTorch yardstick of a matrix log
    for name, replaces, err in (
        ("bandcov_grams", "neural_speech_decoding_tpu/ops/pallas/bandcov.py:35", gram_err),
        ("logcov_feats", "neural_speech_decoding_tpu/ops/pallas/logmfeats.py:63", feat_err),
        ("logcov_feats_chebyshev", "neural_speech_decoding_tpu/ops/pallas/logmfeats.py:239", cheb_err),
        ("logm_clenshaw", "neural_speech_decoding_tpu/ops/pallas/logm.py:39", logm_err),
        ("iir_cascade", "neural_speech_decoding_tpu/ops/pallas/iir.py:38", iir_err),
    ):
        ms, plain_ms, bound_ms, bound_by, library_ms = logcov_times[TIMED[-1]][name]
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"neural_speech_decoding_tpu_torch/csrc/{kernels.SOURCES[name]}.cu",
            "replaces": replaces,
            "launches": launched(name),
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
