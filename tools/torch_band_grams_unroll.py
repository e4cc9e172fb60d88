#!/usr/bin/env python3
"""Time the port's band-gram kernel at several load depths.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_band_grams_unroll.py

csrc/bandcov_grams.cu loads kUnroll 4-row chunks a warp before their
float64 tensor-core instructions run, so that many 128-byte reads are in
flight. This script builds copies of the source with kUnroll set to 2, 4,
8 and 16 (one nvcc each, all started together), prints each build's registers
and spills, holds each against the plain twin and float64 on the
flagship's band layout (logcov8: R = 450, 8 bands), and times each at
B = 1, 1024 and 16384: the mean of 20 back-to-back launches between CUDA
events, and the device-only time from torch.profiler's kernel events, the
depths in the order 2, 4, 8, 16, 16, 8, 4, 2. It prints one JSON line with
the card's name and power limit. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
DEPTH_LINE = "constexpr int kUnroll = 8;"
DEPTHS = (2, 4, 8, 16)
BATCHES = (1, 1024, 16384)
OFFSETS = (0, 30, 60, 100, 150, 210, 290, 370, 450)  # logcov8's bands
F64_TOL = 1.2e-7  # one float32 ulp of each window's max|G| (chip_smoke.py)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_band_grams_unroll: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms, kernel_resources
    from neural_speech_decoding_tpu_torch.ops.kernels import build
    from neural_speech_decoding_tpu_torch.ops.kernels.bandcov import band_grams_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC_DIR / "bandcov_grams.cu").read_text()
    if source.count(DEPTH_LINE) != 1:
        raise RuntimeError("the load depth's line is not in the source")
    procs = {}
    for u in DEPTHS:
        src = build.BUILD_DIR / f"bandcov_grams_unroll{u}.cu"
        src.write_text(source.replace(DEPTH_LINE, f"constexpr int kUnroll = {u};"))
        out = build.BUILD_DIR / f"libbandcov_grams_unroll{u}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[u] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs, resources = {}, {}
    for u, (proc, out) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at depth {u}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.nsd_band_grams.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        lib.nsd_band_grams.restype = ctypes.c_int
        libs[u] = lib
        resources[u] = kernel_resources(log, "band_grams_kernel")
        print(f"depth {u}: {resources[u]}", flush=True)

    offs = (ctypes.c_int * len(OFFSETS))(*OFFSETS)
    nb = len(OFFSETS) - 1
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, y, out):
        err = lib.nsd_band_grams(y.data_ptr(), out.data_ptr(), y.shape[0], y.shape[1], offs, nb, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    result = {"card": smi, "depths": {}}
    for b in BATCHES:
        y = torch.from_numpy(np.random.default_rng(b).standard_normal((b, OFFSETS[-1], 8)).astype(np.float32)).to(dev)
        out = torch.empty((b, nb * 36), device=dev)
        want = band_grams_plain(y, OFFSETS)
        exact = band_grams_plain(y.double(), OFFSETS)
        norm = exact.abs().amax(dim=1, keepdim=True)
        for u, lib in libs.items():
            out.zero_()
            launch(lib, y, out)
            torch.cuda.synchronize()
            err = ((out - want).abs() / norm).max().item()
            err64 = ((out.double() - exact).abs() / norm).max().item()
            if not (err <= 1e-5 and err64 <= F64_TOL):
                raise AssertionError(f"depth {u} B={b}: err {err} vs the twin, {err64} vs float64")
        del want, exact, norm
        calls = {u: [] for u in DEPTHS}
        device = {u: [] for u in DEPTHS}
        for u in DEPTHS + DEPTHS[::-1]:
            calls[u].append(cuda_ms(lambda: launch(libs[u], y, out), 20))
            device[u].append(device_ms(lambda: launch(libs[u], y, out), 20)[0])
        for u in DEPTHS:
            cell = result["depths"].setdefault(str(u), {"resources": resources[u]})
            cell[f"B={b}"] = {"call_ms": calls[u], "device_ms": device[u]}
            print(f"depth {u} B={b}: call mean {calls[u][0]:.4f}, {calls[u][1]:.4f} ms; device-only "
                  f"{device[u][0]:.4f}, {device[u][1]:.4f} ms", flush=True)
        del y, out
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
