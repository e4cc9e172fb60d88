#!/usr/bin/env python3
"""The port's pair-sums kernel against float64 on many single windows.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_pair_sums_accuracy.py

On one window a few samples near z = 0 set the error of the pair sums, so
chip_smoke.py's fixed inputs show one draw of it. This script draws 64
single Gaussian windows (channel 3 dead, as in the smoke) at T = 97, 625
and 1250 and reports, against the same sums in float64, the distribution
of the kernel's largest error over the plain twin's (median, largest, the
share above 2, the seed of the largest), and the mean error of the dead
channel's row over 2048 windows, where a bias of the Hilbert step adds up
over T. It prints one JSON line with the card's name and power limit. It
imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEEDS = 64


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pair_sums_accuracy: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from neural_speech_decoding_tpu_torch.ops.kernels import kuramoto as ku

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    result = {}
    for t in (97, 625, 1250):
        ratios = []
        for seed in range(SEEDS):
            x = np.random.default_rng(seed).standard_normal((1, t, 8)).astype(np.float32) * 40.0
            x[0, :, 3] = 0.0
            xt = torch.from_numpy(x).to(dev)
            exact = ku.kuramoto_pair_sums_plain(xt.double())
            twin = (ku.kuramoto_pair_sums_plain(xt).double() - exact).abs().max()
            kernel = (ku.kuramoto_pair_sums(xt).double() - exact).abs().max()
            ratios.append((kernel / twin).item())
        r = np.array(ratios)
        x = np.random.default_rng(7).standard_normal((2048, t, 8)).astype(np.float32) * 40.0
        x[:, :, 3] = 0.0
        xt = torch.from_numpy(x).to(dev)
        exact = ku.kuramoto_pair_sums_plain(xt.double())
        others = [0, 1, 2, 4, 5, 6, 7]
        result[t] = {
            "ratio_median": float(np.median(r)),
            "ratio_max": float(r.max()),
            "ratio_max_seed": int(r.argmax()),
            "share_above_2": float((r > 2).mean()),
            "dead_row_mean_err_kernel": (ku.kuramoto_pair_sums(xt).double() - exact)[:, 3, others].mean().item(),
            "dead_row_mean_err_twin": (ku.kuramoto_pair_sums_plain(xt).double() - exact)[:, 3, others].mean().item(),
        }
        del xt, exact
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "windows": SEEDS, "lengths": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
