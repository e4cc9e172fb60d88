#!/usr/bin/env python3
"""Time the port's pair-sums kernel with and without its fused passes.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_pair_sums_passes.py

csrc/kuramoto_pair_sums.cu runs two FFT stages of one radix (4 or 5) as one
pass of R^2 points in registers (fused_stages), so T = 625 takes 3
shared-memory passes instead of 7. This script builds the source as it is
and a copy whose host code pairs no stages (every stage then runs alone
through fixed_stage), holds both against the plain twin on Gaussian
windows, and times them in the order fused, single, single, fused at
B = 1024 and 16384. It prints one JSON line with the card's name and power
limit. It imports no JAX.
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
PAIRING = "plan.fused |= 1u << (st - 1);"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pair_sums_passes: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from neural_speech_decoding_tpu_torch.ops.kernels import build
    from neural_speech_decoding_tpu_torch.ops.kernels import kuramoto as ku

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    source = (build.CSRC_DIR / "kuramoto_pair_sums.cu").read_text()
    if source.count(PAIRING) != 1:
        raise RuntimeError("the pairing line of the plan is not in the source")
    single_src = build.BUILD_DIR / "kuramoto_pair_sums_single.cu"
    single_lib = build.BUILD_DIR / "libkuramoto_pair_sums_single.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    single_src.write_text(source.replace(PAIRING, "(void)st;"))
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(single_lib), str(single_src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fused = ku._library()
    log, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    single = ctypes.CDLL(str(single_lib))
    single.nsd_kuramoto_pair_sums.argtypes = fused.nsd_kuramoto_pair_sums.argtypes
    single.nsd_kuramoto_pair_sums.restype = ctypes.c_int

    t = 625
    plan = ku.fft_plan(t)
    radices = (ctypes.c_int * len(plan))(*plan)
    tables = ku.device_tables(t, dev)

    def run(lib, x, out):
        err = lib.nsd_kuramoto_pair_sums(x.data_ptr(), tables.data_ptr(), out.data_ptr(), x.shape[0], t,
                                         radices, len(plan), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def ms(lib, x, out, iters=20):
        run(lib, x, out)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            run(lib, x, out)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    result = {}
    for b in (1024, 16384):
        x = torch.from_numpy((np.random.default_rng(b).standard_normal((b, t, 8)) * 40.0).astype(np.float32)).to(dev)
        want = ku.kuramoto_pair_sums_plain(x)
        outs = {}
        for name, lib in (("fused", fused), ("single", single)):
            outs[name] = torch.empty((b, 8, 8), device=dev)
            run(lib, x, outs[name])
        torch.cuda.synchronize()
        errs = {name: (out - want).abs().max().item() for name, out in outs.items()}
        if max(errs.values()) > 2e-4:
            raise AssertionError(f"B={b}: a variant is more than 2e-4 from the twin: {errs}")
        order = ("fused", "single", "single", "fused")
        times = [ms(fused if name == "fused" else single, x, outs[name]) for name in order]
        result[b] = {
            "fused_ms": [times[0], times[3]],
            "single_ms": [times[1], times[2]],
            "max_abs_err": errs,
            "fused_bitwise_equal_single": bool(torch.equal(outs["fused"], outs["single"])),
        }
        del x, want, outs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "t": t, "radices": list(plan), "batches": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
