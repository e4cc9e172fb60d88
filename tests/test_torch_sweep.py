"""Port parity: the model-selection sweep (tools/sweep.py) of
neural_speech_decoding_tpu_torch against the repository's JAX tool, on the
CPU.

The grids and their expansion equal the JAX tool's. The smoke grid (one
combination: the LSTM, 2 folds, 2 epochs) runs in both tools on the
port's synthetic trial CSVs under $NSD_DATA_DIR (10 trials a class, so
that no fold's training split fills a batch of 32 and the run stays
within seconds on the CPU: the LSTM's backward at T = 625 takes about 10 s
a step here), ranks, and writes JSON whose keys, list lengths and leaf
kinds are the JAX tool's; both score the same reference checkpoint (a .pth
written by the JAX package from checkpoints/lstm3_retrained.npz).
`--train-winner` trains the winner on all trials and writes an .npz that
the JAX package reads and the port serves.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.io.export import decoder_params_to_torch_state, save_torch_checkpoint
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu_torch.io.dataset import write_synthetic_trials
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine
from neural_speech_decoding_tpu_torch.tools import sweep

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_sweep():
    """The repository's tools/sweep.py, which imports its sibling
    crossval.py by name (tools/ on sys.path)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO / "tools"))
        spec = importlib.util.spec_from_file_location("jax_tools_sweep", REPO / "tools" / "sweep.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module, sys.modules["crossval"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    trials = write_synthetic_trials(root / "trials", 10, seed=0)
    pth = root / "reference.pth"
    save_torch_checkpoint(pth, decoder_params_to_torch_state(jax_load_npz(REPO / "checkpoints/lstm3_retrained.npz")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSD_DATA_DIR", str(trials))
        yield {"root": root, "reference": str(pth)}


def structure(tree):
    """Keys, list lengths and leaf kinds of a JSON tree."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [structure(v) for v in tree]
    return "number" if isinstance(tree, (int, float)) and not isinstance(tree, bool) else type(tree).__name__


@pytest.mark.parametrize("grid", sorted(sweep.GRIDS))
def test_expand_matches_jax(jax_sweep, grid):
    module, _ = jax_sweep
    assert sweep.GRIDS[grid] == module.GRIDS[grid]
    assert sweep.expand(sweep.GRIDS[grid]) == module.expand(module.GRIDS[grid])
    assert sorted(sweep.GRIDS) == sorted(module.GRIDS)


def test_smoke_sweep_matches_jax(jax_sweep, env, monkeypatch, capsys):
    module, jax_crossval = jax_sweep
    ours_path, theirs_path = env["root"] / "ours.json", env["root"] / "theirs.json"
    results = sweep.main(["--grid", "smoke", "--out", str(ours_path), "--device", "cpu",
                          "--reference", env["reference"]])
    out = capsys.readouterr().out
    assert "[1/1]" in out and "rank  nested" in out
    monkeypatch.setattr(jax_crossval, "REFERENCE_CKPT", env["reference"])
    monkeypatch.setattr(sys, "argv", ["sweep.py", "--grid", "smoke", "--out", str(theirs_path)])
    module.main()
    ours, theirs = json.loads(ours_path.read_text()), json.loads(theirs_path.read_text())
    assert structure(ours) == structure(theirs)
    assert ours == json.loads(json.dumps(results))
    assert ours[0]["config"] == theirs[0]["config"]
    assert ours[0]["model"] == theirs[0]["model"] == "lstm" and ours[0]["folds"] == 2
    # the same reference checkpoint on the same folds scores the same
    assert ours[0]["reference"] == theirs[0]["reference"]


def test_train_winner(env, capsys):
    out = env["root"] / "winner.npz"
    sweep.main(["--grid", "smoke", "--device", "cpu", "--train-winner", str(out)])
    text = capsys.readouterr().out
    assert "training winner on the full dataset: lstm" in text and f"saved {out} (2 epochs)" in text
    theirs = jax_load_npz(out)
    assert np.asarray(theirs["lstm"][0]["w_hh"]).shape == (48, 192)
    probs = InferenceEngine(str(out), device="cpu").predict_batch(np.zeros((2, 625, 8), np.float32))
    assert probs.shape == (2, 3) and np.allclose(probs.sum(1), 1.0, atol=1e-5)


def test_sweep_without_cuda_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--grid", "smoke"])
