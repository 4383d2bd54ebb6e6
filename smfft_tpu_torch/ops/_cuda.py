"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles each ``csrc/*.cu`` to an object file, all
sources at once in parallel, and links them into one shared library with a
plain C interface under ``smfft_tpu_torch/build/``, named by a hash of every
source (headers included), the flags and the compiler, so a stale library
is never loaded.  The library is bound with ``ctypes``; pointers and the
stream travel as ``c_void_p``, counts as ``c_int64``, flags as ``c_int``.

Each entry point is declared once here (:class:`Entry`); a kernel's
declaration names the one ``__global__`` its library call launches, the
port's one list of its kernels (:data:`LAUNCHED` by launch span, ptxas's
report by :func:`register_report`).  Every kernel wrapper of ``ops/*``
checks its rows with :func:`check_rows` and launches through
:func:`launch`, which reads the stream, takes the device guard where it
must, raises on an error and counts the launch.  A wrapper whose
input is not contiguous rows (a transposed view, a conjugate view) makes
it so with :func:`contiguous`, which counts the bytes it copies.

Nothing is built at import.  CPU tensors never reach the library; a CUDA
tensor's first launch reaches :func:`library`, which raises with the cause
when there is no ``nvcc`` or the build fails.
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

import torch

from smfft_tpu_torch import trace as _T
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
#: bytes that :func:`contiguous` has written since import, on any device
#: (``parallel.dryrun.copied_bytes()``)
copied = 0


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
    ``split`` for a second flag set, ``tail`` for a third, ``cols`` for
    the pass kernel's two radices without a split: its fused column
    launch), fp32 or fp64, registers and spill stores."""
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
            k = _MANGLED.search(name)
            # the integer template arguments, and a second flag after
            # EXACT (the convolutions' bank form, the pass kernel's pair
            # split) and a third (the pass kernel's fused tail); the pass
            # kernel's two radices without a split: its fused column
            # launch
            ints = re.findall(r"Li(\d+)E", k.group(2)) if k else []
            second = bool(k and k.group(4) == "Lb1E")
            pass_kernel = bool(k and k.group(1) == "fourstep_pass_kernel")
            flag = ("" if not second else ",split" if pass_kernel
                    else ",bank")
            flag += ",tail" if k and k.group(5) else ""
            flag += ",cols" if pass_kernel and len(ints) == 2 and not second \
                else ""
            label = f"{k.group(1)}<{','.join(ints)}{flag}>" if k else name
            # the "exact" instantiations compute in double2, or carry the
            # template flag EXACT = true after the sizes
            kind = ("fp64" if "double2" in name
                    or (k and k.group(3) == "Lb1E") else "fp32")
            lines.append(f"{label} {kind}: {m.group(1)} registers, {spill} "
                         "bytes of spill stores")
            name = None
    return lines


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use; binds every
    declared entry point (:data:`ENTRIES`) to its argument and result
    types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build(find_nvcc())))
        for e in ENTRIES:
            fn = getattr(lib, e.symbol)
            fn.argtypes, fn.restype = e.argtypes, e.restype
            e.fn = fn
        _lib = lib
        return _lib


class Entry:
    """One entry point of the library: its C symbol, argument types and
    result type, and the function :func:`library` binds to them; for a
    kernel, its name as ``parallel.dryrun.counts()`` keys it, the one
    ``__global__`` of ``csrc/*.cu`` that its library call launches
    (``function``), and its count, the :func:`launch` calls that returned
    without error."""

    __slots__ = ("kernel", "function", "symbol", "argtypes", "restype", "fn",
                 "count")

    def __init__(self, kernel: str | None, symbol: str, *argtypes,
                 function: str | None = None, restype=ctypes.c_int):
        self.kernel, self.function = kernel, function
        self.symbol, self.argtypes = symbol, argtypes
        self.restype, self.fn, self.count = restype, None, 0
        ENTRIES.append(self)


#: every declared entry point, in the order declared
ENTRIES: list[Entry] = []
_P, _I, _C, _F, _D = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float, ctypes.c_double)
# the helpers: the size and the filling of a C2C plan's constants, the text
# of a CUDA error
C2C_PLAN_BYTES = Entry(None, "smfft_c2c_plan_bytes")
C2C_PREPARE = Entry(None, "smfft_c2c_prepare", _P, _I, _C, _C, _C, _C, _C,
                    _P)
ERROR_STRING = Entry(None, "smfft_error_string", _C, restype=ctypes.c_char_p)
# the twelve kernels, in the order parallel.dryrun.counts() reports them,
# each with the __global__ its library call launches; each takes the
# stream last
C2C_RUN = Entry("c2c", "smfft_c2c_run", _P, _P, _P, _P, _P, _I, _F, _P,
                function="c2c_kernel")
R2C = Entry("r2c", "smfft_r2c", _P, _P, _P, _C, _I, _I, _P, _P, _C, _P,
            function="r2c_kernel")
C2R = Entry("c2r", "smfft_c2r", _P, _P, _C, _P, _I, _I, _F, _P, _P, _C, _P,
            function="c2r_kernel")
C2C_MULTIPLE = Entry("c2c_multiple", "smfft_c2c_multiple", _P, _P, _P, _P,
                     _C, _I, _I, _C, _C, _C, _C, _C, _F, _D, _P, _C, _P,
                     function="c2c_multiple_kernel")
REAL_MULTIPLE = Entry("real_multiple", "smfft_real_multiple", _P, _P, _I, _I,
                      _C, _P, _P, _P, _P, function="real_multiple_kernel")
CONV = Entry("conv", "smfft_conv", _P, _P, _P, _P, _C, _I, _I, _C, _P, _P,
             _P, _C, _P, function="conv_kernel")
CONV_REAL = Entry("conv_real", "smfft_conv_real", _P, _P, _I, _I, _C, _P, _P,
                  _P, _P, _C, _P, function="conv_real_kernel")
POWER = Entry("power", "smfft_power", _P, _P, _P, _I, _I, _P, _P, _P,
              function="power_kernel")
BLUESTEIN = Entry("bluestein", "smfft_bluestein", _P, _P, _P, _P, _C, _I, _I,
                  _I, _I, _P, _P, _D, _P, _C, _P, function="bluestein_kernel")
FOURSTEP_PASS = Entry("fourstep_pass", "smfft_fourstep_pass", _P, _P, _C, _C,
                      _I, _P, _P, _C, _C, _I, _C, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _D, _P, _P, _P, _C, _C, _C, _C, _I, _I, _P, _P,
                      _P, _P, function="fourstep_pass_kernel")
REAL_HUGE = Entry("real_huge", "smfft_real_huge", _C, _P, _C, _P, _P, _C, _I,
                  _I, _I, _I, _D, _P, _P, _C, _C, _P,
                  function="real_huge_kernel")
CONV_PLANE = Entry("conv_plane", "smfft_conv_plane", _P, _P, _I, _I, _I, _C,
                   _C, _P, _P, _C, _P, function="conv_plane_kernel")
#: the kernels' entry points by name
KERNELS = {e.kernel: e for e in ENTRIES if e.kernel}
#: the ``__global__`` that each ``launch:<kernel>`` span's library call runs,
#: by the span's name: one kernel on the card a launch, named by the
#: profiler ``<function><template arguments>``
LAUNCHED = {f"launch:{e.kernel}": e.function for e in KERNELS.values()}
# a kernel instantiation's name as ptxas reports it (mangled): a declared
# ``__global__`` (the longest first), its integer template arguments and up
# to three flags
_MANGLED = re.compile(
    "(" + "|".join(sorted(LAUNCHED.values(), key=len, reverse=True)) + ")"
    r"I((?:Li\d+E)*)(Lb[01]E)?(Lb[01]E)?(Lb1E)?")


def _no_cuda(*_):
    raise RuntimeError("smfft_tpu_torch: this PyTorch build has no CUDA")


# the current device's index, and the raw handle of a device's current
# stream with no ``torch.cuda.Stream`` object built (the accessor Triton's
# launchers use)
_current_device = getattr(torch._C, "_cuda_getDevice", _no_cuda)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_cuda)


# the device type :func:`check_rows` takes: a test seam, not an option (the
# tests of the card path on CPU tensors set "cpu", with the entry points
# stood in); the port sets it nowhere
_CARD = "cuda"


def bound(entry: Entry):
    """``entry``'s function, the library loaded first where it is not."""
    if entry.fn is None:
        library()
    return entry.fn


def launch(entry: Entry, index: int, what: tuple, *args,
           stream: bool = True) -> None:
    """Call ``entry`` with ``args`` on device ``index``, then the device's
    current stream unless ``stream`` is false, under the device's guard only
    where it is not the current device.  A nonzero return raises through
    :func:`check` with ``what``, a format string and its values, formatted
    only then; a call that returned without error adds one to
    ``entry.count``.  Every kernel wrapper launches through here."""
    fn = entry.fn
    if fn is None:
        fn = bound(entry)
    if stream:
        args += (_raw_stream(index),)
    if _current_device() == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        check(err, what[0].format(*what[1:]))
    entry.count += 1


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = bound(ERROR_STRING)(err).decode()
        raise RuntimeError(f"smfft_tpu_torch: {what} failed: CUDA error "
                           f"{err} ({msg})")


def contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where it is contiguous and no conjugate view; else its
    values in a new contiguous tensor, written in one pass (a conjugate
    view resolved in it), the bytes added to :data:`copied` and recorded as
    a ``copy`` span.  What a pass of ``ndim`` over a leading axis costs
    beside its launch.  ``Tensor.contiguous`` where it suffices: its host
    path is ~35 us shorter than ``empty`` and ``copy_`` (on an H100's
    host, at 2^28 points)."""
    global copied
    if x.is_contiguous() and not x.is_conj():
        return x
    t = _T.on and _T.now()
    out = x.contiguous() if not x.is_conj() else torch.empty(
        x.shape, dtype=x.dtype, device=x.device).copy_(x)
    copied += out.nbytes
    if t:
        _T.record(t, "copy", nbytes=out.nbytes)
    return out


def check_rows(x: torch.Tensor, xi: torch.Tensor | None = None,
               dtype: torch.dtype = torch.complex64, width: int | None = None,
               names: tuple = ("x", "xr", "xi")) -> None:
    """A kernel's rows, before their pointers reach the library: ``x`` alone
    of ``dtype``, or ``x, xi`` a planar float32 pair of one shape on one
    device; each a CUDA tensor, (batch, ``width``) (any width where it is
    None), contiguous and no conjugate view.  ``x`` alone is 8-byte aligned
    (a kernel loads it in 8-byte words); a pair's planes are read a float
    at a time, and need only a float's alignment.  ``names``: ``x`` alone,
    then the pair's planes, as the errors name them."""
    planes = (((x, names[0], dtype),) if xi is None else
              ((x, names[1], torch.float32), (xi, names[2], torch.float32)))
    align = 8 if xi is None else 4
    for t, name, want in planes:
        if t.device.type != _CARD:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.dim() != 2 or width is not None and t.shape[1] != width:
            raise ValueError(f"{name} must be (batch, {width or 'n'}), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
        if t.is_conj():
            raise ValueError(f"{name} is a conjugate view: resolve_conj() it")
    if xi is not None and (x.shape != xi.shape or x.device != xi.device):
        raise ValueError(f"planar pair differs: {tuple(x.shape)} on "
                         f"{x.device} vs {tuple(xi.shape)} on {xi.device}")
