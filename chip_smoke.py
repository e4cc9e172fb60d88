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
     number of samples each block sends down the kernel's near-zero path
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
RUN_TRIALS_DEADLINE_S = 120
BATCHES = (1, 37, 1024, 16384)  # the kernel checks' batch sizes
OTHER_T = (97, 1250)  # other window lengths of the pair-sums check
TIMED = (1024, 16384)  # those also timed; the report's times are at the last
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


def check_chebyshev_feats(dev, build_log):
    """Phase 3c: the feature kernel in Chebyshev mode against its twin and
    float64 on the gram kernel's output (at most F64_RATIO times the twin's
    error against float64), flags against the twin's and the rational
    mode's. Returns (max abs err, {B: times})."""
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


def check_clenshaw(dev, build_log):
    """Phase 3c: the Clenshaw kernel on the unwhitened logcov8 band
    covariances of board-like windows (in the domain by the shrinkage
    floor), against its twin and float64 (at most F64_RATIO times the
    twin's error); the port's logm="eigh" route
    (torch.linalg.eigh in batches of at most 16384 matrices, log, product)
    as the library yardstick: it computes the exact log, not the
    polynomial. Returns
    (max abs err, {B: times})."""
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
            line += (f"; kernel {k_ms:.4f} ms (degree 0 {d0_ms:.4f} ms, identity matrices {eye_ms:.4f} ms; "
                     f"wrapper with the torch map and log(tr/C) {w_ms:.4f} ms), "
                     f"plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by}), library: the logm=eigh route "
                     f"(eigh in chunks of {spd.EIGH_BATCH} + log + product; the exact log) {l_ms:.4f} ms")
        phase(line)
        del filtered, s, got, want, exact
    return err_abs, times


def check_iir(dev, build_log):
    """Phase 3c: the zero-phase IIR cascade on detrended board-like windows
    against its twin (timed once: a loop over T) and scipy in float64, at
    most F64_RATIO times the twin's distance from float64; at the timed
    batches the launch plan, the registers and spills of the instantiation
    it runs, the time of both launch shapes (staged in shared memory at
    G = 2, in global memory at G = 1; each also against the twin), and the
    staged shape's bulk copy against its plain copy; then both shapes at
    IIR_SHAPE_BATCHES, either side of the plan's switch. Returns (max abs
    err, {B: times})."""
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
    gram_err = feat_err = 0.0
    logcov_times = {}
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

    # 3c. the slice-3 kernels against their twins
    cheb_err, cheb_times = check_chebyshev_feats(dev, logs.get("logcov_feats"))
    logm_err, logm_times = check_clenshaw(dev, logs.get("logm_clenshaw"))
    iir_err, iir_times = check_iir(dev, logs.get("iir_cascade"))

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

    # 6. report
    k_ms, p_ms, bound, by = times[TIMED[-1]]
    phase(f"kernel times below are at B={TIMED[-1]} (batch {TIMED[0]}: kernel {times[TIMED[0]][0]:.4f} ms, "
          f"plain {times[TIMED[0]][1]:.4f} ms, bound {times[TIMED[0]][2]:.4f} ms)")
    def launched(name):
        return sum(run[name] for run in [main_launches, trial_launches, flagship_launches,
                                         flagship_trial_launches, cheb_launches, cheb_trial_launches,
                                         unw_launches, iir_launches, mix_launches, rec_launches,
                                         tcn_trial_launches] + family_launches)

    logcov_times[TIMED[0]].update(logcov_feats_chebyshev=cheb_times[TIMED[0]], logm_clenshaw=logm_times[TIMED[0]],
                              iir_cascade=iir_times[TIMED[0]])
    logcov_times[TIMED[-1]].update(logcov_feats_chebyshev=cheb_times[TIMED[-1]], logm_clenshaw=logm_times[TIMED[-1]],
                               iir_cascade=iir_times[TIMED[-1]])
    for name, g in logcov_times[TIMED[0]].items():
        phase(f"{name} at B={TIMED[0]}: kernel {g[0]:.4f} ms, plain {g[1]:.4f} ms, bound {g[2]:.4f} ms"
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
