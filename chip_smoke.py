#!/usr/bin/env python
"""GPU smoke run of smfft_tpu_torch: builds the kernel, checks it, and drives
the main path at the working size on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero at once):
  1. Card details and the kernel build from ``smfft_tpu_torch/csrc``.
  2. The kernel against its plain PyTorch version and against the float64
     ``torch.fft`` oracle: every N x forward/inverse x {ordered, revblock
     out, revblock in} x {complex64, planar}, ~2^22 points per call, within
     2e-7 * N^0.75 * 8; the oracle error is also printed in ulp(max|X|).
  3. The main path at 2^27 points per call (512 MB per fp32 plane):
     ``fft`` and ``planar.fft`` / ``planar.ifft`` at N = 1024, 4096, 16384
     and the ``fft(ordered=False)`` -> ``ifft_unordered`` round trip at
     N = 1024.  Median of CUDA-event-timed repetitions, GB/s counted in+out
     (16 bytes per complex point), beside a same-run ``copy_`` of the same
     bytes, the plain version and ``torch.fft``.  Every row of every
     output is checked against the plain version on the same input, and
     a subset of rows against the float64 oracle.
  4. The kernel's launch counter over phase 3 equals the number of calls.
  5. ``smfft_tpu_torch.verify`` 1024 4096 2 0 1 prints PASSED.

The last two lines are a JSON line of kernel results and the device line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

SEED = 1234
SWEEP_POINTS = 1 << 22
MAIN_POINTS = 1 << 27
MAIN_SIZES = (1024, 4096, 16384)
ORACLE_ROWS = 64
REPS = 7


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(n: int) -> float:
    """The error bound the TPU kernels met on their chip."""
    return 2e-7 * n ** 0.75 * 8


def ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 23)


def rand_complex(b: int, n: int, gen: torch.Generator) -> torch.Tensor:
    re = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    im = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    return torch.complex(re, im)


def to_revblock(x: torch.Tensor) -> torch.Tensor:
    b, n = x.shape
    c = max(1, n // 128)
    if c == 1:
        return x
    return x.reshape(b, 128, c).transpose(1, 2).reshape(b, n)


def oracle(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    x64 = x.to(torch.complex128)
    if inverse:
        return torch.fft.ifft(x64) * x.shape[-1]
    return torch.fft.fft(x64)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of fn() over reps runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_card():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")
    print(f"card: {card}")
    from smfft_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds:.1f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return name, card


def phase_sweep():
    """Kernel vs plain version vs float64 oracle at every size/mode."""
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_plain = 0.0
    worst_ulp = 0.0
    modes = (("ordered", False, False), ("rev_out", False, True),
             ("rev_in", True, False))
    for n in SUPPORTED_C2C_SIZES:
        b = SWEEP_POINTS // n
        x = rand_complex(b, n, gen)
        for inverse in (False, True):
            want = oracle(x[:ORACLE_ROWS], inverse)
            max_ulp = ulp(want.abs().max().item())
            for mode, rev_in, rev_out in modes:
                xin = to_revblock(x) if rev_in else x
                w = to_revblock(want) if rev_out else want
                pr, pi = C.c2c_plain(xin.real, xin.imag, inverse=inverse,
                                     rev_in=rev_in, rev_out=rev_out)
                plain = torch.complex(pr, pi)
                got_c = C.launch(xin.contiguous(), inverse=inverse,
                                 rev_in=rev_in, rev_out=rev_out)
                gr, gi = C.launch(xin.real.contiguous(),
                                  xin.imag.contiguous(), inverse=inverse,
                                  rev_in=rev_in, rev_out=rev_out)
                torch.cuda.synchronize()
                for form, got in (("complex", got_c),
                                  ("planar", torch.complex(gr, gi))):
                    e_plain = (got - plain).abs().max().item()
                    e_orc = (got[:ORACLE_ROWS].to(torch.complex128)
                             - w).abs().max().item()
                    print(f"N={n:5d} {'inv' if inverse else 'fwd'} "
                          f"{mode:7s} {form:7s} vs plain {e_plain:.3e} "
                          f"vs oracle {e_orc:.3e} "
                          f"({e_orc / max_ulp:.2f} ulp) "
                          f"bound {bound(n):.3e}")
                    if not (e_plain <= bound(n) and e_orc <= bound(n)):
                        fail(f"N={n} inverse={inverse} {mode} {form}: "
                             f"error over bound")
                    worst_plain = max(worst_plain, e_plain)
                    worst_ulp = max(worst_ulp, e_orc / max_ulp)
        del x
    print(f"sweep: max |kernel - plain| {worst_plain:.3e}, max oracle "
          f"error {worst_ulp:.2f} ulp(max|X|) (the 'exact' tier's contract "
          f"is <= 2 ulp)")
    return worst_plain, worst_ulp


def check_rows(y: torch.Tensor, x: torch.Tensor, inverse: bool, scale,
               what: str) -> None:
    """Shape, finiteness, and the first ORACLE_ROWS rows against float64."""
    if y.shape != x.shape or not bool(torch.isfinite(torch.view_as_real(
            y)).all()):
        fail(f"{what}: wrong shape or non-finite output")
    want = oracle(x[:ORACLE_ROWS], inverse) * (scale or 1.0)
    err = (y[:ORACLE_ROWS].to(torch.complex128) - want).abs().max().item()
    if err > bound(x.shape[-1]):
        fail(f"{what}: error {err:.3e} over bound")


def check_all(y: torch.Tensor, plain: torch.Tensor, what: str) -> float:
    """Every row of y against the plain version's output on the same
    input; returns the max abs error."""
    err = (y - plain).abs().max().item()
    print(f"  {what}: all {y.shape[0]} rows vs plain {err:.3e} "
          f"(bound {bound(y.shape[-1]):.3e})")
    if not err <= bound(y.shape[-1]):
        fail(f"{what}: error {err:.3e} against the plain version over bound")
    return err


def phase_main(card: str):
    """The main path at 2^27 points per call; returns (rows, calls, err):
    err is the largest error of a main-path output against the plain
    version, over every row."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import c2c as C
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, calls, worst = [], 0, 0.0
    C.launch.count = 0
    for n in MAIN_SIZES:
        b = MAIN_POINTS // n
        x = rand_complex(b, n, gen)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        gb = 16.0 * MAIN_POINTS / 1e9
        # the plain version at the main path's own shapes (no launches):
        # every row of every output below is held against it
        fwd = torch.complex(*C.c2c_plain(xr, xi))

        y = T.fft(x)
        calls += 1
        check_rows(y, x, False, None, f"fft N={n}")
        worst = max(worst, check_all(y, fwd, f"fft N={n}"))
        del y
        o = T.planar.fft(xr, xi)
        calls += 1
        y = torch.complex(*o)
        check_rows(y, x, False, None, f"planar.fft N={n}")
        worst = max(worst, check_all(y, fwd, f"planar.fft N={n}"))
        del o, y
        if n == 1024:
            u = T.fft(x, ordered=False)
            back = T.ifft_unordered(u)
            calls += 2
            worst = max(worst, check_all(u, to_revblock(fwd),
                                         f"fft(ordered=False) N={n}"))
            err = (back - x).abs().max().item()
            print(f"  fft(ordered=False) -> ifft_unordered round trip: "
                  f"max |x' - x| {err:.3e}")
            if err > bound(n):
                fail("round trip over bound")
            del u, back
        del fwd
        inv = torch.complex(*C.c2c_plain(xr, xi, inverse=True,
                                         scale=1.0 / n))
        o = T.planar.ifft(xr, xi)
        calls += 1
        y = torch.complex(*o)
        check_rows(y, x, True, 1.0 / n, f"planar.ifft N={n}")
        worst = max(worst, check_all(y, inv, f"planar.ifft N={n}"))
        del o, y, inv

        ms_fft = cuda_ms(lambda: T.fft(x))
        calls += 1 + REPS
        ms_pfft = cuda_ms(lambda: T.planar.fft(xr, xi))
        calls += 1 + REPS
        ms_pifft = cuda_ms(lambda: T.planar.ifft(xr, xi))
        calls += 1 + REPS
        if n == 1024:
            ms_rt = cuda_ms(lambda: T.ifft_unordered(T.fft(x, ordered=False)))
            calls += 2 * (1 + REPS)
        else:
            ms_rt = None

        # references at the same shapes (no kernel launches)
        dst = torch.empty_like(x)
        ms_copy = cuda_ms(lambda: dst.copy_(x))
        del dst
        ms_plain = cuda_ms(lambda: C.c2c_plain(xr, xi), reps=3)
        ms_torch = cuda_ms(lambda: torch.fft.fft(x))
        row = {"n": n, "batch": b, "fft_ms": ms_fft, "planar_fft_ms": ms_pfft,
               "planar_ifft_ms": ms_pifft, "roundtrip_ms": ms_rt,
               "copy_ms": ms_copy, "plain_ms": ms_plain,
               "torch_fft_ms": ms_torch}
        rows.append(row)
        print(f"N={n:5d} batch={b} ({card}): "
              f"fft {ms_fft:.4f} ms = {gb / ms_fft * 1e3:.1f} GB/s | "
              f"planar.fft {ms_pfft:.4f} ms = {gb / ms_pfft * 1e3:.1f} GB/s | "
              f"planar.ifft {ms_pifft:.4f} ms = "
              f"{gb / ms_pifft * 1e3:.1f} GB/s | "
              f"copy_ {ms_copy:.4f} ms = {gb / ms_copy * 1e3:.1f} GB/s | "
              f"plain {ms_plain:.4f} ms | torch.fft {ms_torch:.4f} ms"
              + (f" | round trip {ms_rt:.4f} ms" if ms_rt else ""))
        print(f"  fft at {ms_copy / ms_fft:.3f} of the copy roofline; "
              f"planar.fft at {ms_copy / ms_pfft:.3f}")
        del x, xr, xi
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    try:
        import smfft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: smfft_tpu_torch is not importable here ({e}); run "
              "from the root of a checkout")
        return 1
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in fp32
    torch.set_float32_matmul_precision("highest")

    name, card = phase_card()
    worst_plain, _ = phase_sweep()

    from smfft_tpu_torch.ops import c2c as C
    rows, calls, worst_main = phase_main(card)
    launches = C.launch.count
    print(f"launch counter over the main path: {launches} "
          f"(expected {calls})")
    if launches != calls or launches == 0:
        fail("the main path did not go through the kernel once per call")

    from smfft_tpu_torch import verify
    if verify.main(["1024", "4096", "2", "0", "1"]) != 0:
        fail("verify 1024 4096 2 0 1 did not pass")
    if "jax" in sys.modules:
        fail("jax was imported")

    main_row = rows[0]
    print("main path rows: " + json.dumps({"card": card, "rows": rows}))
    print("c2c also replaces smfft_tpu/ops/pencil.py:206 (iters = 1); "
          f"ms and plain_ms are fft at N={main_row['n']}, "
          f"batch={main_row['batch']}")
    print(json.dumps({"kernels": [{
        "name": "c2c",
        "route": "cuda",
        "source": "smfft_tpu_torch/csrc/c2c.cu",
        "replaces": "smfft_tpu/ops/pallas_c2c.py:1015",
        "launches": launches,
        "max_abs_err": max(worst_plain, worst_main),
        "ms": main_row["fft_ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
