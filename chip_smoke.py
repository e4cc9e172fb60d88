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
     same function
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
FLAGSHIP = ROOT / "checkpoints" / "logcov8wd_ens_manifest.json"
FLAGSHIP_MEMBER = ROOT / "checkpoints" / "logcov8wd_ens_s0.npz"
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
# Features: the JAX package's kernel-vs-stages limit, 5e-5 max(scale, 1),
# with the scale taken per window, as for the grams: a railed window's
# features (about 33) would loosen the limit for the others (about 2.4).
LOGCOV_FEATS_TOL = 5e-5
LOGIT_TOL = 1e-4  # the JAX package's f32 fidelity budget
PROB_TOL = 1e-4
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


def band_grams_bound_ms(b: int, rows: int, nb: int, band_rows: int) -> tuple[float, str]:
    """Least time for the band-gram pairs of b windows: the rows read once
    and the pairs written once; 2 operations per product and pair."""
    nbytes = 4 * (b * rows * C + b * nb * PAIRS)
    t_ops = 2 * PAIRS * band_rows * b / PEAK_F32_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def logcov_feats_bound_ms(b: int, nb: int, terms: int) -> tuple[float, str]:
    """Least time for the features of b windows and nb bands. Bytes: the
    gram pairs, traces and W W^T pairs read once, the features (float32)
    and flags (1 byte) written once. Operations per 8x8 matrix: the
    kernel's pivot-free Gauss-Jordan (about 29 kFLOP for 12 poles) is its
    choice, not the floor; the least work is a Householder tridiagonal
    reduction (4/3 C^3), a tridiagonal inverse per pole (3 C^2), the
    back-transformation (2 C^3), the Cholesky guard (C^3 / 3) and 6
    elementwise operations per pair (shrinkage, weighting)."""
    per_matrix = 4 * C**3 / 3 + terms * 3 * C**2 + 2 * C**3 + C**3 / 3 + 6 * PAIRS
    nbytes = 4 * (2 * b * nb * PAIRS + b * nb + nb * PAIRS) + b * nb
    t_ops = b * nb * per_matrix / PEAK_F32_FLOP_S
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


def logcov_kernel_inputs(b: int, seed: int, dev):
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
    cfg = get_model("logcov8", whiten=True, dropout=0.0).config
    w = torch.from_numpy(load_params_npz(FLAGSHIP_MEMBER)["whitener"]).to(dev)
    w = w * torch.where(torch.arange(C, device=dev) == 5, 0.1, 1.0)[None, None, :]
    return logcov.kernel_inputs(filtered, w, cfg)


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

    # 3 (continued). the flagship's two kernels against their twins
    gram_err = feat_err = 0.0
    logcov_times = {}
    for b in (1, 37, 1024, 16384):
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
        line = (f"band grams B={b}: max err {err:.3e} of each window's max|G| (tol {BAND_GRAMS_REL_TOL}); "
                f"vs float64: kernel {k64:.3e}, twin {p64:.3e}")
        del exact

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
        if b >= 3 and not (flags[0].all() and flags[2].any() and not flags.all()):
            raise AssertionError(f"logcov feats B={b}: the guard did not fire as the inputs demand")
        feat_err = max(feat_err, fdiff.max().item())
        line2 = (f"logcov feats B={b}: max err {ferr:.3e} of each window's max(scale, 1) "
                 f"(tol {LOGCOV_FEATS_TOL}; largest scale {fnorm.max().item():.3f}), "
                 f"max abs err {fdiff.max().item():.3e}; "
                 f"flags equal ({int(flags.sum())} of {flags.numel()} set); vs float64: kernel max "
                 f"{(feats.double() - exact_f).abs().max().item():.3e}, twin max "
                 f"{(want_f.double() - exact_f).abs().max().item():.3e}, float64 flags differ in "
                 f"{int((exact_flags != flags).sum())}")
        del exact_f, exact_flags, fdiff
        if b >= 1024:
            nb = len(k.offsets) - 1
            g_ms = cuda_ms(lambda: band_grams(k.yw, k.offsets), 20)
            gp_ms = cuda_ms(lambda: band_grams_plain(k.yw, k.offsets), 10)
            padded = padded_bands(k.yw, k.offsets)
            pt = padded.transpose(1, 2)
            gl_ms = cuda_ms(lambda: torch.matmul(pt, padded), 20)
            del padded, pt
            g_bound, g_by = band_grams_bound_ms(b, k.yw.shape[1], nb, k.offsets[-1] - k.offsets[0])
            f_ms = cuda_ms(lambda: logcov_feats(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars), 20)
            fp_ms = cuda_ms(lambda: logcov_feats_plain(got, k.tr_scaled, k.wwt_pairs, k.coeffs, **k.scalars), 3)
            f_bound, f_by = logcov_feats_bound_ms(b, nb, (len(k.coeffs) - 1) // 2)
            logcov_times[b] = {
                "bandcov_grams": (g_ms, gp_ms, g_bound, g_by, gl_ms),
                "logcov_feats": (f_ms, fp_ms, f_bound, f_by, None),
            }
            line += (f"; kernel {g_ms:.4f} ms, plain {gp_ms:.4f} ms, padded bmm {gl_ms:.4f} ms, "
                     f"bound {g_bound:.4f} ms ({g_by})")
            line2 += f"; kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms, bound {f_bound:.4f} ms ({f_by})"
        phase(line)
        phase(line2)
        del k, got, want, feats, flags, want_f, want_flags

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
    if min(flagship_launches.values()) < 1:
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
    if min(flagship_trial_launches.values()) < 3:
        raise AssertionError(f"flagship run_trials launched a kernel too rarely: {flagship_trial_launches}")
    favg = fresult.avg_probs
    if fresult.trials != 3 or favg is None or favg.shape != (3,) or not np.isfinite(favg).all():
        raise AssertionError(f"flagship run_trials: bad result {fresult}")
    if abs(float(favg.sum()) - 1.0) > 1e-5:
        raise AssertionError("flagship run_trials: averaged probabilities do not sum to 1")
    phase(f"flagship run_trials_ex(3) on SyntheticBoard(speed=64): avg_probs {np.round(favg, 4).tolist()}; "
          f"launches {flagship_trial_launches}")

    # 6. report
    k_ms, p_ms, bound, by = times[16384]
    phase(f"kernel times below are at B=16384 (batch 1024: kernel {times[1024][0]:.4f} ms, "
          f"plain {times[1024][1]:.4f} ms, bound {times[1024][2]:.4f} ms)")
    def launched(name):
        return sum(run[name] for run in (main_launches, trial_launches, flagship_launches,
                                         flagship_trial_launches))

    for name in ("bandcov_grams", "logcov_feats"):
        g = logcov_times[1024][name]
        phase(f"{name} at B=1024: kernel {g[0]:.4f} ms, plain {g[1]:.4f} ms, bound {g[2]:.4f} ms"
              + ("" if g[4] is None else f", library {g[4]:.4f} ms"))
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
    for name, replaces, err in (
        ("bandcov_grams", "neural_speech_decoding_tpu/ops/pallas/bandcov.py:35", gram_err),
        ("logcov_feats", "neural_speech_decoding_tpu/ops/pallas/logmfeats.py:63", feat_err),
    ):
        ms, plain_ms, bound_ms, bound_by, library_ms = logcov_times[16384][name]
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"neural_speech_decoding_tpu_torch/csrc/{name}.cu",
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
