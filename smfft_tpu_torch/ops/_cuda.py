"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles the sources into one shared library with a
plain C interface under ``smfft_tpu_torch/build/``, named by a hash of the
sources, flags and compiler, so a stale library is never loaded.  The
library is bound with ``ctypes``; pointers and the stream travel as
``c_void_p``, counts as ``c_int64``.

Nothing here runs at import.  CPU tensors never reach this module; a CUDA
tensor that does reaches :func:`library`, which raises with the cause when
there is no ``nvcc`` or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from smfft_tpu_torch.config import debug_print

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas register / shared-memory report) and
# how long it took; empty until a build ran in this process
build_log = ""
build_seconds = 0.0


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, torch's CUDA_HOME, /usr/local/cuda or PATH."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes.append("/usr/local/cuda")
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "smfft_tpu_torch: the CUDA kernels need nvcc to build, and none was "
        "found (looked in $CUDA_HOME, torch's CUDA_HOME, /usr/local/cuda "
        "and PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build(nvcc: str) -> Path:
    global build_log, build_seconds
    sources = _sources()
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([nvcc] + ARCH_FLAGS + NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libsmfft_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sources]]
    debug_print("build CUDA kernels:", " ".join(cmd))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"smfft_tpu_torch: nvcc failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build(find_nvcc())))
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.smfft_c2c.argtypes = [vp, vp, vp, vp, ci, i64, i64, ci, ci, ci,
                                  ctypes.c_float, vp, vp]
        lib.smfft_c2c.restype = ci
        lib.smfft_error_string.argtypes = [ci]
        lib.smfft_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().smfft_error_string(err).decode()
        raise RuntimeError(f"smfft_tpu_torch: {what} failed: CUDA error "
                           f"{err} ({msg})")
