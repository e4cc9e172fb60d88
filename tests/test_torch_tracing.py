"""The port's tracing helpers on the CPU: `device_trace` writes a Chrome
trace of the enclosed block under the directory it yields (given, or
$NSD_TRACE_DIR/<timestamp> as in the JAX package's helper), the trace
names an `annotate` range and the operators run inside it, `annotate`
works with and without a trace running, and `device_trace` refuses to run
without CUDA unless the CPU is named.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu_torch.config import FilterConfig
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch
from neural_speech_decoding_tpu_torch.utils.tracing import TRACE_FILE, annotate, device_trace


def _events(log_dir):
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_trace_names_the_annotated_range(tmp_path):
    x = np.random.default_rng(0).standard_normal((4, 625, 8)).astype(np.float32)
    with device_trace(str(tmp_path / "t"), device="cpu") as log_dir:
        with annotate("filter"):
            out = mai_filter_batch(x, FilterConfig(precision="fast"), device="cpu")
    assert log_dir == str(tmp_path / "t") and out.shape == (4, 625, 8)
    events = _events(log_dir)
    spans = [e for e in events if e.get("name") == "filter" and e.get("ph") == "X"]
    assert len(spans) == 1
    start, end = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    inside = {e["name"] for e in events if e.get("ph") == "X" and start <= e["ts"] <= end}
    assert "aten::matmul" in inside  # the twin's Hilbert operator, inside the range


def test_default_directory_under_trace_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("NSD_TRACE_DIR", str(tmp_path))
    with device_trace(device="cpu") as log_dir:
        torch.ones(3).sum()
    assert os.path.dirname(log_dir) == str(tmp_path)
    assert re.fullmatch(r"\d{8}T\d{6}", os.path.basename(log_dir))
    assert os.path.isfile(os.path.join(log_dir, TRACE_FILE))


def test_annotate_without_a_trace():
    with annotate("idle"):
        y = torch.arange(4.0) * 2
    assert y.tolist() == [0.0, 2.0, 4.0, 6.0]
    # nested ranges, and an exception passes through
    with pytest.raises(KeyError):
        with annotate("outer"), annotate("inner"):
            raise KeyError("x")


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with device_trace(str(tmp_path), device="cpu"), annotate("failing"):
            raise ValueError("boom")
    assert any(e.get("name") == "failing" for e in _events(str(tmp_path)))


def test_device_trace_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with device_trace(str(tmp_path)):
            pass
