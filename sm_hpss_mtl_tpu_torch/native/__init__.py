"""Native C++ host kernels (ctypes bindings), the counterpart of
``sm_hpss_mtl_tpu/native``.

``kernels.cpp`` is a copy of the JAX package's source.  It is compiled at
first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/torch_native/`` at the repository root (nothing is written into
the package), and rebuilt when the source is newer than the library.
Every entry point has a numpy twin (``ops/patches.py``, ``ops/silence.py``,
``ops/stats.py``, ``data/batcher.py::scale_frames``), which the tests hold
it to; the host pipeline calls these kernels where the JAX package does.

There is no fallback: a failed build raises, with the compiler's message,
on the first call of any kernel, because a quiet switch to numpy would
change the noise stream (``add_gaussian_noise`` draws from its own
xoshiro256++ ziggurat sampler, not numpy's).  ``available()`` and
``build_error()`` are for callers that ask first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("kernels.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_PATH = BUILD_DIR / "libkernels.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile ``kernels.cpp`` into :data:`LIB_PATH`; returns the compiler's
    message on failure.  The library is written to a temporary file and
    renamed, so concurrent processes never load a half-written one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"{' '.join(cmd)}: {type(e).__name__}: {e}"
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"{' '.join(cmd)}:\n{proc.stderr[-2000:]}"
    os.replace(tmp, LIB_PATH)
    return None


def _load() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        if not LIB_PATH.exists() or (LIB_PATH.stat().st_mtime
                                     < SOURCE.stat().st_mtime):
            _build_error = _build()
            if _build_error is not None:
                return
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError as e:
            _build_error = f"loading {LIB_PATH}: {e}"
            return
        i64, i32, f32p, f64p, i64p = (ctypes.c_int64, ctypes.c_int32,
                                      np.ctypeslib.ndpointer(np.float32),
                                      np.ctypeslib.ndpointer(np.float64),
                                      np.ctypeslib.ndpointer(np.int64))
        for fn in (lib.extract_patches_f32, lib.standardize_rows_f32,
                   lib.scale_frames_f32, lib.patch_statistics_f64,
                   lib.add_gaussian_noise_f32):
            fn.restype = None
        lib.extract_patches_f32.argtypes = [f32p, i64, i64, i64, i64, i64, f32p]
        lib.standardize_rows_f32.argtypes = [f32p, i64, i64]
        lib.scale_frames_f32.argtypes = [f32p, f32p, f32p, i64, i64, f32p]
        lib.silence_segments.restype = i64
        lib.silence_segments.argtypes = [f64p, i64, i64, ctypes.c_double,
                                         i64, i64, ctypes.c_double,
                                         ctypes.c_double, i64p, i64, i64p]
        lib.patch_statistics_f64.argtypes = [f64p, i64, i64, i64, i32, i32,
                                             f64p]
        lib.add_gaussian_noise_f32.argtypes = [f32p, i64, ctypes.c_float,
                                               ctypes.c_uint64]
        _lib = lib


def available() -> bool:
    """Whether the library built and loaded (builds it on first call)."""
    _load()
    return _lib is not None


def build_error() -> str | None:
    """The compiler's message if the build failed, else None."""
    _load()
    return _build_error


def _library():
    _load()
    if _lib is None:
        raise RuntimeError(f"the native host kernels did not build:\n"
                           f"{_build_error}")
    return _lib


# ---------------------------------------------------------------------------
# Wrappers (numpy signatures)
# ---------------------------------------------------------------------------

def extract_patches(fv: np.ndarray, patch_size: int,
                    patch_shift: int) -> np.ndarray:
    """Native twin of ``ops.patches.extract_patches_np``."""
    from ..ops.patches import _start_indices, tiled_length
    lib = _library()
    fv = np.ascontiguousarray(fv, dtype=np.float32)
    D, T = fv.shape
    full_T = tiled_length(T, patch_size)
    if full_T != T:
        reps = -(-full_T // T)
        fv = np.ascontiguousarray(np.tile(fv, (1, reps))[:, :full_T])
    n = len(_start_indices(full_T, patch_size, patch_shift))
    out = np.empty((n, D, patch_size), np.float32)
    lib.extract_patches_f32(fv, D, full_T, patch_size, patch_shift, n, out)
    return out


def standardize_rows(fv: np.ndarray) -> np.ndarray:
    """Native twin of ``ops.patches.standardize_rows``: per row over time,
    in float64, a constant row centred to 0."""
    lib = _library()
    out = np.array(fv, dtype=np.float32, order="C")
    if out.ndim != 2:
        raise ValueError(f"standardize_rows takes (D, T), got {out.shape}")
    lib.standardize_rows_f32(out, out.shape[0], out.shape[1])
    return out


def scale_frames(fv: np.ndarray, mean: np.ndarray,
                 stdev: np.ndarray) -> np.ndarray:
    """Native twin of ``data.batcher.scale_frames``."""
    lib = _library()
    fv = np.ascontiguousarray(fv, dtype=np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    stdev = np.ascontiguousarray(stdev, np.float32)
    if fv.ndim != 2 or mean.shape != (fv.shape[0],) \
            or stdev.shape != (fv.shape[0],):
        raise ValueError(f"scale_frames takes (D, T) features and (D,) "
                         f"statistics, got {fv.shape}, {mean.shape}, "
                         f"{stdev.shape}")
    out = np.empty_like(fv)
    lib.scale_frames_f32(fv, mean, stdev, fv.shape[0], fv.shape[1], out)
    return out


def remove_silence(x: np.ndarray, energy: np.ndarray, fs: int,
                   Tw: int = 25, Ts: int = 10, alpha: float = 0.025,
                   beta: float = 0.075):
    """Native twin of ``ops.silence.remove_silence``."""
    lib = _library()
    frame_size = int(Tw * fs / 1000)
    frame_shift = int(Ts * fs / 1000)
    energy = np.ascontiguousarray(energy, np.float64)
    n_frames = len(energy)
    n = len(x)
    segments = np.zeros(2 * n_frames + 2, np.int64)
    marker = np.zeros(n_frames, np.int64)
    n_seg = lib.silence_segments(energy, n_frames, n, float(fs),
                                 frame_size, frame_shift, alpha, beta,
                                 segments, n_frames, marker)
    sample_marker = np.ones(n, np.int64)
    total = 0.0
    for s in range(n_seg):
        k, l = segments[2 * s], segments[2 * s + 1]
        sample_marker[k:l] = 0
        total += (l - k) / fs
    if n_seg > 1:
        x_out = x[sample_marker == 1]
    else:
        x_out = x
    return x_out, sample_marker, marker, total


def add_gaussian_noise(x: np.ndarray, scale: float, seed: int) -> None:
    """In place, ``x += scale * N(0, 1)`` over a contiguous float32 array,
    from the xoshiro256++ ziggurat sampler seeded per call: the same field
    as the JAX package's for the same (seed, shape)."""
    lib = _library()
    if x.dtype != np.float32 or not x.flags["C_CONTIGUOUS"]:
        raise ValueError("add_gaussian_noise takes a C-contiguous float32 "
                         "array")
    lib.add_gaussian_noise_f32(x.reshape(-1), x.size,
                               np.float32(scale), np.uint64(seed))


_STATS = {"mean": 0, "variance": 1, "skew": 2, "kurtosis": 3}


def patch_statistics(fv: np.ndarray, stat_type: str = "skew",
                     axis: int = 0) -> np.ndarray:
    """Native twin of ``ops.stats.patch_statistics`` over (N, F, T)
    patches: per column (``axis=0``, (N, T)) or per row (``axis=1``,
    (N, F)), in float64."""
    lib = _library()
    if axis not in (0, 1):
        raise ValueError("axis must be 0 (columns) or 1 (rows)")
    fv = np.ascontiguousarray(fv, np.float64)
    N, F, T = fv.shape
    out = np.empty((N, T if axis == 0 else F), np.float64)
    lib.patch_statistics_f64(fv, N, F, T, _STATS[stat_type], axis, out)
    return out
