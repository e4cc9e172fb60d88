"""Tests of the port that need the card: the CUDA pair-sums kernel against
its plain twin, and the engine on CUDA against the engine on the CPU.

No JAX here (the machine with the card has none); run there with
  python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest -p no:cacheprovider
Elsewhere every test skips.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu_torch.ops import kernels
from neural_speech_decoding_tpu_torch.ops.kernels.kuramoto import (
    kuramoto_pair_sums,
    kuramoto_pair_sums_plain,
)
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine

REPO = Path(__file__).resolve().parents[1]
T, C = 625, 8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _windows(n: int, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((n, T, C)) * 40.0).astype(np.float32)
    x[0, :, 3] = 0.0  # dead channel: c2 = 1, s2 = 0
    return x


@pytest.mark.parametrize("batch", [1, 2, 3, 37])
def test_kernel_matches_plain(cuda, batch):
    """f32 tree sums of 625 O(1) terms in different orders: abs 2e-4 on
    values up to 625 (a running f32 sum over T reads about 1.7e-3)."""
    x = torch.from_numpy(_windows(batch, batch)).to(cuda)
    before = kernels.launches()["kuramoto_pair_sums"]
    got = kuramoto_pair_sums(x)
    torch.cuda.synchronize()
    assert kernels.launches()["kuramoto_pair_sums"] == before + 1
    want = kuramoto_pair_sums_plain(x)
    assert got.shape == (batch, C, C)
    assert (got - want).abs().max().item() <= 2e-4
    assert torch.equal(got, got.transpose(1, 2))
    assert got[0, 3, 3].item() == float(T)


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        kuramoto_pair_sums(torch.zeros(2, T, C, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        kuramoto_pair_sums(torch.zeros(2, T, 4, device=cuda))
    with pytest.raises(ValueError):
        kuramoto_pair_sums(torch.zeros(2, C, T, device=cuda).transpose(1, 2))
    assert kuramoto_pair_sums(torch.zeros(0, T, C, device=cuda)).shape == (0, C, C)


def test_engine_cuda_matches_cpu(cuda):
    """The whole pipeline on the card (kernel route) against the CPU (plain
    twin): <= 1e-4 max |delta logit|, the f32 fidelity budget."""
    path = str(REPO / "checkpoints" / "lstm3_retrained.npz")
    x = _windows(16, 7) / 40.0
    gpu = InferenceEngine(path).logits_batch(x)
    cpu = InferenceEngine(path, device="cpu").logits_batch(x)
    assert np.abs(gpu - cpu).max() <= 1e-4
