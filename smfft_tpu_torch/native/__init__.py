"""ctypes bindings for the host-side harness (``harness.cpp``).

Seeded fixture generators and the reference's hybrid error metric, as C
for big-batch verification runs, with numpy implementations of the same
semantics for hosts without a C++ compiler.  This is host code: it never
touches the GPU.  The library is built from this package's own copy of
``harness.cpp`` by its ``Makefile`` into ``libsmfft_host.so`` here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libsmfft_host.so"
_lock = threading.Lock()
_lib = None
_tried = False


class CompareStats(ctypes.Structure):
    _fields_ = [
        ("total_error", ctypes.c_double),
        ("mean_error", ctypes.c_double),
        ("max_error", ctypes.c_double),
        ("error_count", ctypes.c_int64),
    ]


def _build() -> bool:
    """make into a private name, then rename: concurrent builders (test
    workers) never load a half-written library."""
    tmp = f".libsmfft_host.{os.getpid()}.so"
    try:
        subprocess.run(["make", "-C", str(_DIR), f"lib={tmp}"], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(_DIR / tmp, _LIB_PATH)
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() and not _build():
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.smfft_generate_uniform.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float,
            ctypes.c_float]
        lib.smfft_generate_uniform.restype = None
        lib.smfft_generate_two_tone.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.smfft_generate_two_tone.restype = None
        lib.smfft_compare.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(CompareStats)]
        lib.smfft_compare.restype = None
        _lib = lib
        return _lib


def _hybrid_error_np(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The reference's error metric (get_error, FFT.c:23-49): absolute
    difference, decade-normalized where |want| > 10."""
    err = np.abs(want - got)
    mag = np.abs(want)
    big = mag > 10.0
    with np.errstate(divide="ignore"):
        decade = np.where(big, 10.0 ** np.floor(np.log10(
            np.where(big, mag, 1.0))), 1.0)
    return err / decade


def generate_uniform(count: int, seed: int, lo: float = -0.5,
                     hi: float = 0.5) -> np.ndarray:
    """``count`` seeded uniform fp32 values in [lo, hi)."""
    lib = get_lib()
    out = np.empty(count, np.float32)
    if lib is not None:
        lib.smfft_generate_uniform(out, count, seed, lo, hi)
        return out
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(count, dtype=np.float32))


def generate_two_tone(n_ffts: int, n: int, f1: float = 17.0, a1: float = 1.0,
                      f2: float = 41.0, a2: float = 0.5) -> np.ndarray:
    """The reference's Generate_signal (FFT.c:14-21): (n_ffts, n) rows of
    two sinusoids."""
    lib = get_lib()
    out = np.empty(n_ffts * n, np.float32)
    if lib is not None:
        lib.smfft_generate_two_tone(out, n_ffts, n, f1, a1, f2, a2)
        return out.reshape(n_ffts, n)
    i = np.arange(n)
    sig = (a1 * np.sin(2 * np.pi * f1 * i / n)
           + a2 * np.sin(2 * np.pi * f2 * i / n)).astype(np.float32)
    return np.broadcast_to(sig, (n_ffts, n)).copy()


def compare_np(got: np.ndarray, want: np.ndarray,
               tolerance: float = 1e-4) -> dict:
    """numpy implementation of :func:`compare`."""
    g = np.ascontiguousarray(got, np.complex64).view(np.float32).reshape(-1, 2)
    w = np.ascontiguousarray(want, np.complex64).view(np.float32).reshape(-1, 2)
    e = np.maximum(_hybrid_error_np(g[:, 0], w[:, 0]),
                   _hybrid_error_np(g[:, 1], w[:, 1]))
    return {"total_error": float(e.sum()), "mean_error": float(e.mean()),
            "max_error": float(e.max()),
            "error_count": int((e > tolerance).sum())}


def compare(got: np.ndarray, want: np.ndarray,
            tolerance: float = 1e-4) -> dict:
    """Element-wise complex compare with the reference's metric and
    tolerance default (max_error = 1e-4, FFT.c:12): max over re and im of
    the hybrid error, with total, mean, max and the count over
    tolerance."""
    lib = get_lib()
    if lib is None:
        return compare_np(got, want, tolerance)
    g = np.ascontiguousarray(got, np.complex64).view(np.float32)
    w = np.ascontiguousarray(want, np.complex64).view(np.float32)
    st = CompareStats()
    lib.smfft_compare(g.reshape(-1), w.reshape(-1), g.size // 2, tolerance,
                      ctypes.byref(st))
    return {"total_error": st.total_error, "mean_error": st.mean_error,
            "max_error": st.max_error, "error_count": int(st.error_count)}
