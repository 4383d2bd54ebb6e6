"""Time the C2C, R2C, reuse, Bluestein and huge-N paths of one or more
checkouts of smfft_tpu_torch on one GPU, in turns, so that two versions
are compared on the same card in one run.

    python -m smfft_tpu_torch.c2c_ab PARENT_ROOT . . PARENT_ROOT

Each root runs in its own process (each builds its own kernels), with
about 2^27 complex points or real samples per call, precision "highest":

  * ``fft`` and ``planar.fft`` at N = 1024, 4096, 16384, the median of 25
    (``fft``) or 15 CUDA-event-timed calls after a warm-up, beside a
    same-run ``copy_`` of the same bytes and ``torch.fft.fft``;
  * ``planar.rfft`` and ``rfft`` (numpy layout) at n = 1024, 4096, 16384,
    the median of 15, beside a same-run ``copy_`` of the real bytes and
    ``torch.fft.rfft``;
  * ``fft_any`` at n = 1000 (131072 rows) and 4097 (32768 rows), and
    ``fft_large`` at N = 2^15, 2^20, 2^24, 2^27, the median of 15;
  * the reuse loops at 100 transforms a call: ``fft_planar(
    multiple_iters=100)`` at N = 1024, 4096, 16384,
    ``multiple_pencil_planar(iters=100)`` and
    ``multiple_real_pencil_planar(iters=100)`` at 1024 and 4096, the median
    of 5, beside the same root's single-pass calls on the same shape
    (``planar.fft``; ``planar.rfft`` and ``planar.irfft`` for a real pair)
    and the ratio of 100 single transforms to one reuse call;
  * the fp32 error of ``fft`` / ``ifft`` (64 rows, every N) and of ``rfft``
    (64 rows, every n) against float64 ``torch.fft``, in ulp(max|X|).

Prints one JSON line per root and the registers and spills ptxas gave each
instantiation of the kernels both roots build the same way (C2R,
convolution, power, huge-N real, and the kernels already on the Hopper
core hcore.cuh: C2C, R2C, Bluestein and the four-step pass) in that root's
build, whether those are the same in every root, then the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from smfft_tpu_torch.ops._cuda import register_report

# the kernel instantiations whose registers and spills are compared
SHARED_KERNELS = ("c2r_kernel", "conv_kernel", "conv_real_kernel",
                  "power_kernel", "real_huge_kernel", "bluestein_kernel",
                  "fourstep_pass_kernel", "c2c_kernel", "r2c_kernel")

CHILD = r"""
import json, math, statistics, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import smfft_tpu_torch as T
from smfft_tpu_torch.ops import _cuda
assert T.__file__.startswith(root), T.__file__
_cuda.library()
def ms(fn, reps=15):
    fn(); torch.cuda.synchronize(); ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)
def ulps(y, want):
    u = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 23)
    return (y.to(want.dtype) - want).abs().max().item() / u
out = {"root": root, "rows": [], "ptxas": _cuda.build_log,
       "ulp_fp32": {"fft": {}, "rfft": {}}}
gen = torch.Generator(device="cuda").manual_seed(1234)
for n in (1024, 4096, 16384):
    b = (1 << 27) // n
    x = torch.complex(torch.rand((b, n), generator=gen, device="cuda"),
                      torch.rand((b, n), generator=gen, device="cuda"))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    dst = torch.empty_like(x)
    out["rows"].append({"n": n, "fft_ms": ms(lambda: T.fft(x), 25),
                        "planar_fft_ms": ms(lambda: T.planar.fft(xr, xi)),
                        "copy_ms": ms(lambda: dst.copy_(x)),
                        "torch_fft_ms": ms(lambda: torch.fft.fft(x))})
    del x, xr, xi, dst
    torch.cuda.empty_cache()
for n in (1024, 4096, 16384):
    x = torch.rand(((1 << 27) // n, n), generator=gen, device="cuda") - 0.5
    dst = torch.empty_like(x)
    out["rows"].append({"n": n, "planar_rfft_ms": ms(lambda: T.planar.rfft(x)),
                        "rfft_ms": ms(lambda: T.rfft(x)),
                        "copy_real_ms": ms(lambda: dst.copy_(x)),
                        "torch_rfft_ms": ms(lambda: torch.fft.rfft(x))})
    del x, dst
    torch.cuda.empty_cache()
from smfft_tpu_torch.ops import c2c as OC
from smfft_tpu_torch.ops import multiple as OM
for n in (1024, 4096, 16384):
    b = (1 << 27) // n
    xr = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    xi = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    single = ms(lambda: T.planar.fft(xr, xi))
    row = {"n": n, "reuse_fft_planar_ms": ms(lambda: OC.fft_planar(
               xr, xi, n, ordered=True, multiple_iters=100), 5),
           "single_planar_fft_ms": single}
    row["fft_planar_ratio_to_single"] = 100 * single / row[
        "reuse_fft_planar_ms"]
    if n <= 4096:
        row["reuse_pencil_ms"] = ms(
            lambda: OM.multiple_pencil_planar(xr, xi, n, 100), 5)
        row["pencil_ratio_to_single"] = 100 * single / row["reuse_pencil_ms"]
        hr, hi = T.planar.rfft(xr)
        pair = ms(lambda: T.planar.rfft(xr)) + ms(
            lambda: T.planar.irfft(hr, hi))
        row["reuse_real_ms"] = ms(
            lambda: OM.multiple_real_pencil_planar(xr, n, 100), 5)
        row["single_rfft_irfft_ms"] = pair
        row["real_ratio_to_single"] = 50 * pair / row["reuse_real_ms"]
        del hr, hi
    out["rows"].append(row)
    del xr, xi
    torch.cuda.empty_cache()
for n in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
    # both parts centred: a DC bin of N/2 would set max|X| for every kernel
    x = torch.complex(torch.rand((64, n), generator=gen, device="cuda") - 0.5,
                      torch.rand((64, n), generator=gen, device="cuda") - 0.5)
    x64 = x.to(torch.complex128)
    out["ulp_fp32"]["fft"][n] = max(
        ulps(T.fft(x), torch.fft.fft(x64)),
        ulps(T.ifft(x), torch.fft.ifft(x64)))
    if 2 * n <= 16384:
        xr = torch.cat([x.real, x.imag], dim=1)
        out["ulp_fp32"]["rfft"][2 * n] = ulps(
            T.rfft(xr), torch.fft.rfft(xr.double()))
for n, b in ((1000, 1 << 17), (4097, 1 << 15)):
    x = torch.complex(torch.rand((b, n), generator=gen, device="cuda"),
                      torch.rand((b, n), generator=gen, device="cuda"))
    out["rows"].append({"n": n, "fft_any_ms": ms(lambda: T.fft_any(x))})
    del x
    torch.cuda.empty_cache()
for n in (1 << 15, 1 << 20, 1 << 24, 1 << 27):
    x = torch.complex(torch.rand(((1 << 27) // n, n), generator=gen,
                                 device="cuda"),
                      torch.rand(((1 << 27) // n, n), generator=gen,
                                 device="cuda"))
    out["rows"].append({"n": n, "fft_large_ms": ms(lambda: T.fft_large(x))})
    del x
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("roots", nargs="+", help="checkout roots, in run order")
    args = p.parse_args(argv)
    reports = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(Path(root).resolve())],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        # the registers and spills of the kernels every root has, from this
        # root's own build
        regs = sorted(r for r in register_report(res.pop("ptxas"))
                      if r.startswith(SHARED_KERNELS))
        reports.append(regs)
        print(json.dumps(res), flush=True)
        for r in regs:
            print(f"  ptxas {Path(root).name or root}: {r}")
    reports = [r for r in reports if r]  # a root's older build: no log
    print(f"c2r / conv / power / real_huge / bluestein / fourstep_pass / "
          f"c2c / r2c instantiations report the same "
          f"registers and spills in the {len(reports)} roots with a ptxas "
          f"report: "
          f"{bool(reports) and all(r == reports[0] for r in reports)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
