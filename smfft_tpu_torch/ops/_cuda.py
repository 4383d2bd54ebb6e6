"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles each ``csrc/*.cu`` to an object file, all
sources at once in parallel, and links them into one shared library with a
plain C interface under ``smfft_tpu_torch/build/``, named by a hash of every
source (headers included), the flags and the compiler, so a stale library
is never loaded.  The library is bound with ``ctypes``; pointers and the
stream travel as ``c_void_p``, counts as ``c_int64``, flags as ``c_int``.

Nothing here runs at import.  CPU tensors never reach this module; a CUDA
tensor that does reaches :func:`library`, which raises with the cause when
there is no ``nvcc`` or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the build of the loaded library printed (ptxas register /
# shared-memory report; kept beside the library, so a cached build has it
# too) and how long a build in this process took (0 for a cached one)
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
    """Every file the library is built from: the .cu units and the headers
    they include."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Start every command at once, then wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [subprocess.CompletedProcess(c, p.returncode, o, "")
            for c, p, o in zip(cmds, procs, outs)]


def _build(nvcc: str) -> Path:
    global build_log, build_seconds
    sources = _sources()
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([nvcc] + ARCH_FLAGS + NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libsmfft_kernels_{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        # a library built earlier: its ptxas report, for register_report
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    units = [s for s in sources if s.suffix == ".cu"]
    objs = [tmp / f"{s.stem}.o" for s in units]
    compile_cmds = [[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(o),
                     str(s)] for s, o in zip(units, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
            *map(str, objs)]
    for cmd in compile_cmds + [link]:
        debug_print("build CUDA kernels:", " ".join(cmd))
    t0 = time.perf_counter()
    done = _run_all(compile_cmds)
    if all(p.returncode == 0 for p in done):
        done += _run_all([link])
    build_seconds = time.perf_counter() - t0
    build_log = "".join(p.stdout for p in done)
    failed = [p for p in done if p.returncode != 0]
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"smfft_tpu_torch: nvcc failed (exit {failed[0].returncode}):\n"
            f"{' '.join(failed[0].args)}\n{build_log}")
    # atomic: concurrent builders never see half a file
    (tmp / "lib.log").write_text(build_log)
    os.replace(tmp / "lib.log", log)
    os.replace(tmp / "lib.so", out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def register_report(log: str | None = None) -> list[str]:
    """One line per kernel instantiation from ptxas's report in a build
    log: the kernel, its integer template arguments (and ``bank`` or
    ``split`` for a second flag set), fp32 or fp64, registers and spill
    stores."""
    lines, name, spill = [], None, 0
    for line in (build_log if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"(c2c_multiple_kernel|real_multiple_kernel|"
                          r"conv_real_kernel|conv_kernel|[cr]2[cr]_kernel|"
                          r"power_kernel|bluestein_kernel|"
                          r"fourstep_pass_kernel|real_huge_kernel)"
                          r"I((?:Li\d+E)*)(Lb[01]E)?(Lb1E)?", name)
            # the integer template arguments, and a second flag after
            # EXACT (the convolutions' bank form, the pass kernel's pair
            # split)
            flag = ("" if not k or not k.group(4) else ",split"
                    if k.group(1) == "fourstep_pass_kernel" else ",bank")
            label = (f"{k.group(1)}<"
                     f"{','.join(re.findall(r'Li(\d+)E', k.group(2)))}"
                     f"{flag}>" if k else name)
            # the "exact" instantiations compute in double2, or carry the
            # template flag EXACT = true after the sizes
            kind = ("fp64" if "double2" in name
                    or (k and k.group(3) == "Lb1E") else "fp32")
            lines.append(f"{label} {kind}: {m.group(1)} registers, {spill} "
                         "bytes of spill stores")
            name = None
    return lines


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build(find_nvcc())))
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f32 = ctypes.c_float
        lib.smfft_c2c_plan_bytes.argtypes = []
        lib.smfft_c2c_prepare.argtypes = [vp, i64, ci, ci, ci, ci, ci, vp]
        lib.smfft_c2c_run.argtypes = [vp, vp, vp, vp, vp, i64, f32, vp]
        lib.smfft_r2c.argtypes = [vp, vp, vp, ci, i64, i64, vp, vp, ci, vp]
        lib.smfft_c2r.argtypes = [vp, vp, ci, vp, i64, i64, f32, vp, vp, ci,
                                  vp]
        lib.smfft_c2c_multiple.argtypes = [vp, vp, vp, vp, ci, i64, i64, ci,
                                           ci, ci, ci, ci, f32,
                                           ctypes.c_double, vp, ci, vp]
        lib.smfft_real_multiple.argtypes = [vp, vp, i64, i64, ci, vp, vp, vp,
                                            vp]
        lib.smfft_conv.argtypes = [vp, vp, vp, vp, ci, i64, i64, ci, vp, vp,
                                   vp, ci, vp]
        lib.smfft_conv_real.argtypes = [vp, vp, i64, i64, ci, vp, vp, vp, vp,
                                        ci, vp]
        lib.smfft_power.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp]
        lib.smfft_bluestein.argtypes = [vp, vp, vp, vp, ci, i64, i64, i64,
                                        i64, vp, vp, ctypes.c_double, vp, ci,
                                        vp]
        lib.smfft_fourstep_pass.argtypes = [vp, vp, ci, ci, i64, vp, vp, ci,
                                            ci, i64, ci, i64, i64, i64, i64,
                                            i64, i64, i64, i64,
                                            ctypes.c_double, vp, vp, vp, ci,
                                            ci, ci, ci, i64, vp]
        lib.smfft_real_huge.argtypes = [ci, vp, ci, vp, vp, ci, i64, i64, i64,
                                        i64, ctypes.c_double, vp, vp, ci, ci,
                                        vp]
        for fn in (lib.smfft_c2c_plan_bytes, lib.smfft_c2c_prepare,
                   lib.smfft_c2c_run, lib.smfft_r2c, lib.smfft_c2r,
                   lib.smfft_c2c_multiple, lib.smfft_real_multiple,
                   lib.smfft_conv, lib.smfft_conv_real, lib.smfft_power,
                   lib.smfft_bluestein, lib.smfft_fourstep_pass,
                   lib.smfft_real_huge):
            fn.restype = ci
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
