"""Profiler tracing helpers.

Counterpart of neural_speech_decoding_tpu/utils/tracing.py:18-40, on
torch.profiler: a context manager that captures a trace of the enclosed
block (a Chrome trace, viewable in Perfetto or chrome://tracing), and an
annotation range that names a span in that trace and, once CUDA is
initialised, in NVTX as well. Outside a trace an annotation records
nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, device: DeviceLike = None) -> Iterator[str]:
    """Capture a torch.profiler trace of the enclosed block: CPU activity,
    plus CUDA activity when `device` (CUDA unless named) is a CUDA device.
    The directory defaults to $NSD_TRACE_DIR or ./traces/<timestamp>; the
    trace is written there as trace.json when the block ends. Yields the
    directory."""
    dev = resolve_device(device)
    if log_dir is None:
        base = os.environ.get("NSD_TRACE_DIR", "traces")
        log_dir = os.path.join(base, time.strftime("%Y%m%dT%H%M%S"))
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: a torch.profiler.record_function span (recorded only
    while a trace runs) and, when CUDA is initialised, an NVTX range."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
