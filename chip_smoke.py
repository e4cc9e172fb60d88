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
     path's shapes, with the tolerance stated, and both against the same
     sums in float64; kernel, twin and bound times
  4. the main path: InferenceEngine.predict_batch on 1024 synthetic raw
     windows, with the kernels' launch counts set to 0 just before and read
     just after; then 16 of those windows against the same engine on the
     CPU (max |delta logit|)
  5. run_trials(trials=3) on a SyntheticBoard(speed=64) under an overall
     deadline, launch counts again set to 0 before and read after
  6. a JSON line of the kernels, then the result line

Any failure raises and exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "lstm3_retrained.npz"
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
LOGIT_TOL = 1e-4  # the JAX package's f32 fidelity budget
RUN_TRIALS_DEADLINE_S = 120

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


def pair_sums_inputs(b: int, seed: int, device) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((b, T, C)).astype(np.float32) * 40.0
    x[0, :, 3] = 0.0  # an all-zero channel: c2 = 1, s2 = 0
    if b > 2:
        x[-1] = 0.0  # an all-zero window
    return torch.from_numpy(x).to(device)


def pair_sums_bound_ms(b: int) -> tuple[float, str]:
    """Least time for the pair sums of b windows on an H100 SXM, from the
    least work the function needs. The Hilbert step is a linear map that an
    FFT does in O(T log T): a real FFT and its inverse per channel, 2.5 T
    log2 T operations each, plus T for the gain. The dense [T, T] product
    that the TPU kernel and this kernel do (2 T^2 C) is their choice, not
    the floor. Then about 10 operations per sample for c2/s2 and 4 per pair
    and sample for the sums. Bytes: x read once and G written once."""
    per_window = C * (5.0 * T * np.log2(T) + T) + 10 * T * C + 4 * PAIRS * T
    nbytes = 4 * (b * T * C + b * C * C)
    t_ops, t_bytes = b * per_window / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits
    from neural_speech_decoding_tpu_torch.ops import kernels
    from neural_speech_decoding_tpu_torch.ops.kernels import build
    from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
        kuramoto_pair_sums,
        kuramoto_pair_sums_plain,
    )
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
    from neural_speech_decoding_tpu_torch.runtime.board import SyntheticBoard
    from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
    from neural_speech_decoding_tpu_torch.runtime.tester import run_trials

    torch.set_num_threads(1)  # the CPU comparison runs tiny eager ops
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
    logs = build.build(list(kernels.LAUNCHES))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                phase(f"build {name}: {line.strip()}")
    phase(f"built {sorted(kernels.LAUNCHES)} ({len(logs)} compiled now)")

    # 3. kernel against its plain twin
    max_err = 0.0
    times = {}
    for b in (1, 37, 1024, 16384):
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
        line = (f"pair sums B={b}: max abs err {err:.3e} (tol {PAIR_SUMS_ABS_TOL}); "
                f"vs float64: kernel max {k64.max().item():.3e} mean {k64.mean().item():.3e}, "
                f"twin max {p64.max().item():.3e} mean {p64.mean().item():.3e}")
        del exact, k64, p64
        if b >= 1024:
            k_ms = cuda_ms(lambda: kuramoto_pair_sums(x), 20)
            p_ms = cuda_ms(lambda: kuramoto_pair_sums_plain(x), 10)
            bound, by = pair_sums_bound_ms(b)
            times[b] = (k_ms, p_ms, bound, by)
            line += f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by})"
        phase(line)
        del x, got, want

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

    # 6. report
    k_ms, p_ms, bound, by = times[16384]
    phase(f"kernel times below are at B=16384 (batch 1024: kernel {times[1024][0]:.4f} ms, "
          f"plain {times[1024][1]:.4f} ms, bound {times[1024][2]:.4f} ms)")
    report = {
        "kernels": [
            {
                "name": "kuramoto_pair_sums",
                "route": "cuda",
                "source": "neural_speech_decoding_tpu_torch/csrc/kuramoto_pair_sums.cu",
                "replaces": "neural_speech_decoding_tpu/ops/pallas/kuramoto.py:60",
                "launches": main_launches["kuramoto_pair_sums"] + trial_launches["kuramoto_pair_sums"],
                "max_abs_err": max_err,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,
            }
        ]
    }
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
