"""Golden-reference verification harness — the reference's L4 main().

Usage (the reference's positional CLI, SMFFT_CooleyTukey_C2C/FFT.c:84-92):

  python -m smfft_tpu_torch.verify <FFT_size> <nFFTs> [nRuns] [inverse]
                                   [reorder] [--device auto|cuda|cpu]
                                   [--precision P] [--seed S]
                                   [--two-tone] [--tolerance T]

Each run makes seeded input, computes the float64 numpy golden spectrum,
runs the transform through :mod:`smfft_tpu_torch.api` on the device
(``auto``: the GPU when there is one, else the CPU and the plain version),
compares with the reference's hybrid error metric and tolerance (1e-4,
FFT.c:12), and prints the time and a green PASSED / red FAILED verdict.
On a GPU the time is the kernel's, from CUDA events; on the CPU it is a
host clock.  Unordered output (``reorder`` = 0) is revblock on both
devices; it is un-permuted and verified.

nFFTs is rounded up to the packing multiple 128/N for N = 32 / 64, as the
reference does (FFT.c:105-116).  Only C2C is ported: ``--kind r2c`` and
``--kind c2r`` raise NotImplementedError (ROADMAP A4).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

GREEN, RED, RESET = "\033[1;32m", "\033[1;31m", "\033[0m"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fft_size", type=int)
    p.add_argument("n_ffts", type=int)
    p.add_argument("n_runs", type=int, nargs="?", default=1)
    p.add_argument("inverse", type=int, nargs="?", default=0)
    p.add_argument("reorder", type=int, nargs="?", default=1)
    p.add_argument("--kind", choices=["c2c", "r2c", "c2r"], default="c2c")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"],
                   default="auto")
    p.add_argument("--precision", default="highest")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--two-tone", action="store_true",
                   help="two-tone fixture instead of uniform noise")
    p.add_argument("--tolerance", type=float, default=1e-4,
                   help="reference max_error (FFT.c:12)")
    return p.parse_args(argv)


def _timed_runs(fn, x, n_runs: int, device):
    """Warm up once, then time n_runs calls: CUDA events around each call
    on a GPU, the host clock on a CPU.  Returns (output, ms per run)."""
    import torch

    out = fn(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        times = []
        for _ in range(n_runs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return out, times
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        out = fn(x)
        times.append(1e3 * (time.perf_counter() - t0))
    return out, times


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.kind != "c2c":
        raise NotImplementedError(
            f"--kind {args.kind} is not ported yet (ROADMAP A4: real "
            "transforms)")
    import torch

    from smfft_tpu_torch import api, native
    from smfft_tpu_torch.config import flags

    if args.device == "auto":
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        device = torch.device(args.device)
    n, n_ffts = args.fft_size, args.n_ffts
    pack = max(1, 128 // n)
    if n_ffts % pack:
        n_ffts += pack - n_ffts % pack
        print(f"nFFTs rounded up to {n_ffts} (multiple of {pack})")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain PyTorch version)")
    print(f"device: {kind}, kind=c2c, N={n}, nFFTs={n_ffts}, "
          f"runs={args.n_runs}, inverse={args.inverse}, "
          f"reorder={args.reorder}")

    if args.two_tone:
        re = native.generate_two_tone(n_ffts, n)
        im = np.zeros_like(re)
    else:
        re = native.generate_uniform(n_ffts * n, args.seed).reshape(n_ffts, n)
        im = native.generate_uniform(n_ffts * n, args.seed + 1).reshape(
            n_ffts, n)
    x = (re + 1j * im).astype(np.complex64)
    golden = (np.fft.ifft(x.astype(np.complex128)) * n if args.inverse
              else np.fft.fft(x.astype(np.complex128)))

    ordered = bool(args.reorder)
    if args.inverse:
        def fn(a):  # reference contract: unnormalized inverse
            return api.ifft(a, ordered=ordered, precision=args.precision,
                            norm=None)
    else:
        def fn(a):
            return api.fft(a, ordered=ordered, precision=args.precision)

    xd = torch.from_numpy(x).to(device)
    out, times = _timed_runs(fn, xd, args.n_runs, device)
    got = out.cpu().numpy()
    c = max(1, n // 128)
    if not ordered and c > 1:
        # revblock -> natural (the reference leaves this mode unverified,
        # FFT.c:161-163; the layout is fixed, so verify it anyway)
        got = got.reshape(n_ffts, c, 128).transpose(0, 2, 1).reshape(
            n_ffts, n)

    mean_ms, med_ms = float(np.mean(times)), float(np.median(times))
    runs = ", ".join(f"{t:.4f}" for t in times)
    if device.type == "cuda":
        gbs = 16.0 * n_ffts * n / (med_ms * 1e-3) / 1e9
        print(f"smFFT time: {mean_ms:.4f} ms/run mean, {med_ms:.4f} median "
              f"of {args.n_runs} (CUDA events: {runs}); {gbs:.2f} GB/s "
              "counted in+out at the median")
    else:
        print(f"smFFT time: {mean_ms:.4f} ms/run mean of {args.n_runs} "
              "(host clock, CPU)")
    if not flags.testing:
        # reference behavior with TESTING off: timing only
        print("no verification (SMFFT_TESTING=0)")
        return 0
    stats = native.compare(got, golden.astype(np.complex64), args.tolerance)
    print(f"total error: {stats['total_error']:.6e}  "
          f"mean error: {stats['mean_error']:.6e}  "
          f"max error: {stats['max_error']:.6e}")
    ok = stats["error_count"] == 0
    verdict = f"{GREEN}PASSED{RESET}" if ok else (
        f"{RED}FAILED{RESET} ({stats['error_count']} elements over "
        f"tolerance {args.tolerance})")
    print(verdict)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
