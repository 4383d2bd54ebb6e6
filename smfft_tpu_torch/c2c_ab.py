"""Time the C2C, Bluestein and huge-N paths of one or more checkouts of
smfft_tpu_torch on one GPU, in turns, so that two versions are compared
on the same card in one run.

    python -m smfft_tpu_torch.c2c_ab PARENT_ROOT . . PARENT_ROOT

Each root runs in its own process (each builds its own kernels), with
about 2^27 complex points per call, precision "highest":

  * ``fft`` and ``planar.fft`` at N = 1024, 4096, 16384, the median of 25
    (``fft``) or 15 CUDA-event-timed calls after a warm-up, beside a
    same-run ``copy_`` of the same bytes;
  * ``fft_any`` at n = 1000 (131072 rows) and 4097 (32768 rows), and
    ``fft_large`` at N = 2^15, 2^20, 2^24, 2^27, the median of 15.

Prints one JSON line per root and the registers and spills ptxas gave each
instantiation of the kernels this change leaves alone (C2C, R2C, C2R,
reuse loops, convolution, power, huge-N real) in that root's build,
whether those are the same in every root, then the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from smfft_tpu_torch.ops._cuda import register_report

# the kernel instantiations whose registers and spills are compared
SHARED_KERNELS = ("c2c_kernel", "r2c_kernel", "c2r_kernel",
                  "c2c_multiple_kernel", "real_multiple_kernel",
                  "conv_kernel", "conv_real_kernel", "power_kernel",
                  "real_huge_kernel")

CHILD = r"""
import json, statistics, sys
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
out = {"root": root, "rows": [], "ptxas": _cuda.build_log}
gen = torch.Generator(device="cuda").manual_seed(1234)
for n in (1024, 4096, 16384):
    b = (1 << 27) // n
    x = torch.complex(torch.rand((b, n), generator=gen, device="cuda"),
                      torch.rand((b, n), generator=gen, device="cuda"))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    dst = torch.empty_like(x)
    out["rows"].append({"n": n, "fft_ms": ms(lambda: T.fft(x), 25),
                        "planar_fft_ms": ms(lambda: T.planar.fft(xr, xi)),
                        "copy_ms": ms(lambda: dst.copy_(x))})
    del x, xr, xi, dst
    torch.cuda.empty_cache()
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
    print(f"c2c / r2c / c2r / multiple / conv / power / real_huge "
          f"instantiations report the same "
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
