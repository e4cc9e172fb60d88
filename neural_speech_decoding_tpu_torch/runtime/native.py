"""ctypes bindings for the C++ board runtime and DSP (native/nsd_board.cpp,
native/nsd_dsp.cpp).

Counterpart of neural_speech_decoding_tpu/runtime/native.py:30-175. The
C++ side keeps the host sample path out of Python: a ring buffer fed by a
C++ producer thread (a synthetic generator or a replay source), drained by
`get_current_board_data` into caller-provided NumPy memory, and in-place
biquad cascades for the collector's DSP.

The port builds its own library from the two sources with g++ and
native/Makefile's flags, into build/nsd_torch_native/libnsdboard-<hash>.so
at the root of the checkout, at first use, under a lock. The hash covers
both sources and the flags, so an edited source gets a new library and a
stale one is never loaded. A failed build raises with the compiler's log:
nothing falls back to the pure-Python board. $NSD_NATIVE_LIB may name a
prebuilt library instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_ENV = "NSD_NATIVE_LIB"
REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
SOURCES = ("nsd_board.cpp", "nsd_dsp.cpp")
BUILD_DIR = REPO_ROOT / "build" / "nsd_torch_native"
# native/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
_BUILD_TIMEOUT_S = 300

_MODES = {"synthetic": 0, "replay": 1}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the build of the current sources and flags lives."""
    blob = b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
    digest = hashlib.sha256(blob + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libnsdboard-{digest}.so"


def build() -> Path:
    """Compile the library if this hash has none yet; returns its path.
    Raises RuntimeError with the compiler's log when g++ fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nsd_board_create.restype = ctypes.c_void_p
    lib.nsd_board_create.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_int,  # num_rows
        ctypes.c_int,  # num_channels
        ctypes.c_int,  # sample_rate
        ctypes.c_uint64,  # seed
    ]
    lib.nsd_board_load_replay.restype = ctypes.c_int
    lib.nsd_board_load_replay.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,  # channels
        ctypes.c_long,  # total samples
    ]
    lib.nsd_board_start.restype = ctypes.c_int
    lib.nsd_board_start.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_double]
    lib.nsd_board_stop.restype = None
    lib.nsd_board_stop.argtypes = [ctypes.c_void_p]
    lib.nsd_board_release.restype = None
    lib.nsd_board_release.argtypes = [ctypes.c_void_p]
    lib.nsd_board_data_count.restype = ctypes.c_long
    lib.nsd_board_data_count.argtypes = [ctypes.c_void_p]
    lib.nsd_board_get_current.restype = ctypes.c_long
    lib.nsd_board_get_current.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.nsd_dsp_detrend_constant.restype = None
    lib.nsd_dsp_detrend_constant.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    for fn in (lib.nsd_dsp_sosfilt, lib.nsd_dsp_sosfiltfilt):
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library: $NSD_NATIVE_LIB when set, else the port's own
    build (compiled first if needed). Raises when it cannot be built or
    loaded; never returns None."""
    global _lib
    with _lock:
        if _lib is None:
            env = os.environ.get(_LIB_ENV)
            if env:
                if not Path(env).is_file():
                    raise FileNotFoundError(f"${_LIB_ENV} names no file: {env}")
                path = Path(env)
            else:
                path = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _as_c_double(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def native_detrend_constant(x: np.ndarray) -> np.ndarray:
    """Per-channel constant detrend through the C++ DSP. x: [..., T]."""
    lib = load_library()
    out = np.array(x, dtype=np.float64, order="C", copy=True)
    flat = out.reshape(-1, out.shape[-1])
    for row in flat:
        lib.nsd_dsp_detrend_constant(_as_c_double(row), row.shape[0])
    return out


def native_sosfilt(x: np.ndarray, sos: np.ndarray, zero_phase: bool = False) -> np.ndarray:
    """Biquad cascade along the last axis through the C++ DSP
    (scipy.signal.sosfilt semantics; zero_phase: the pad-free
    forward-backward pass)."""
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [S, 6], got {sos.shape}")
    lib = load_library()
    out = np.array(x, dtype=np.float64, order="C", copy=True)
    flat = out.reshape(-1, out.shape[-1])
    fn = lib.nsd_dsp_sosfiltfilt if zero_phase else lib.nsd_dsp_sosfilt
    for row in flat:
        rc = fn(_as_c_double(row), row.shape[0], _as_c_double(sos), sos.shape[0])
        if rc != 0:
            raise RuntimeError(f"native sosfilt failed rc={rc}")
    return out


class NativeBoardHandle:
    """Owns one C++ board instance."""

    def __init__(self, lib: ctypes.CDLL, mode: str, num_rows: int,
                 num_channels: int, sample_rate: int, seed: int = 0):
        self.lib = lib
        self.num_rows = num_rows
        self._ptr = lib.nsd_board_create(
            _MODES[mode], num_rows, num_channels, sample_rate, ctypes.c_uint64(seed),
        )
        if not self._ptr:
            raise RuntimeError("nsd_board_create failed")

    def load_replay(self, data_ct: np.ndarray) -> None:
        if data_ct.dtype != np.float32 or not data_ct.flags.c_contiguous or data_ct.ndim != 2:
            raise ValueError("replay data must be a C-contiguous float32 [C, T] array")
        # the C++ side copies the samples before it returns
        rc = self.lib.nsd_board_load_replay(
            self._ptr,
            data_ct.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data_ct.shape[0],
            data_ct.shape[1],
        )
        if rc != 0:
            raise RuntimeError(f"nsd_board_load_replay failed rc={rc}")

    def start(self, buffer_size: int, speed: float) -> None:
        rc = self.lib.nsd_board_start(self._ptr, buffer_size, speed)
        if rc != 0:
            raise RuntimeError(f"nsd_board_start failed rc={rc}")

    def stop(self) -> None:
        if self._ptr:
            self.lib.nsd_board_stop(self._ptr)

    def release(self) -> None:
        if self._ptr:
            self.lib.nsd_board_release(self._ptr)
            self._ptr = None

    def data_count(self) -> int:
        return int(self.lib.nsd_board_data_count(self._ptr)) if self._ptr else 0

    def get_current(self, n: int) -> np.ndarray:
        out = np.empty((self.num_rows, n), dtype=np.float64)
        if not self._ptr:
            return out[:, :0]
        got = int(self.lib.nsd_board_get_current(
            self._ptr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        ))
        # the C++ side fills [rows, n] with row stride n, left-aligned
        return np.ascontiguousarray(out[:, :got]) if got < n else out

    def __del__(self):  # pragma: no cover
        try:
            self.release()
        except Exception:
            pass
