"""Golden-reference verification harness — the reference's L4 main().

Usage (the reference's positional CLI, SMFFT_CooleyTukey_C2C/FFT.c:84-92):

  python -m smfft_tpu_torch.verify <FFT_size> <nFFTs> [nRuns] [inverse]
                                   [reorder] [--kind c2c|r2c|c2r]
                                   [--device cuda|cpu] [--precision P]
                                   [--seed S] [--two-tone] [--tolerance T]

Each run makes seeded input, computes the float64 numpy golden result,
runs the transform through :mod:`smfft_tpu_torch.api` on the device,
compares with the reference's hybrid error metric and tolerance (1e-4,
FFT.c:12), and prints the time and a green PASSED / red FAILED verdict.

It runs on the GPU (the kernels) unless ``--device cpu`` asks for the CPU
and the plain versions; without a GPU and without ``--device cpu`` it
exits non-zero and runs nothing.  On a GPU the time is the kernel's, from
CUDA events; on the CPU it is a host clock.

Kinds, as the JAX package's root ``verify.py``:
  * ``c2c``: ``fft`` / raw ``ifft`` (``inverse``), natural or revblock
    (``reorder`` = 0, un-permuted and verified);
  * ``r2c``: ``fft_packed_real``, slot 0 = (DC, Nyquist), against numpy's
    rfft (Compare_R2C_output);
  * ``c2r``: raw ``irfft`` of numpy's rfft of the signal, (N/2)-scaled,
    against the signal (Compare_C2R_output).
nFFTs is rounded up to the packing multiple (128/N for C2C at N = 32 / 64,
128/(N/2) for real at N = 64 / 128), as the reference does
(FFT.c:105-116).
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the kernels; the default) or cpu (the plain "
                        "versions)")
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


def _inputs(args, n: int, n_ffts: int):
    """(input array, the transform of the device tensor, the comparison of
    its output with the float64 golden result) for the kind."""
    from smfft_tpu_torch import api, native

    def uniform(seed):
        return native.generate_uniform(n_ffts * n, seed).reshape(n_ffts, n)

    prec = args.precision
    if args.kind == "r2c":
        x = uniform(args.seed)
        golden = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
        return (x, lambda a: api.fft_packed_real(a, precision=prec),
                lambda got, tol: native.compare_r2c_packed(got, golden, tol))
    if args.kind == "c2r":
        x = uniform(args.seed)
        spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
        # reference contract: raw output, compared at scale N/2
        return (spec, lambda a: api.irfft(a, n=n, precision=prec, norm=None),
                lambda got, tol: native.compare_real(
                    got, x, got_scale=n // 2, want_scale=1.0, tolerance=tol))
    if args.two_tone:
        re = native.generate_two_tone(n_ffts, n)
        im = np.zeros_like(re)
    else:
        re, im = uniform(args.seed), uniform(args.seed + 1)
    x = (re + 1j * im).astype(np.complex64)
    golden = (np.fft.ifft(x.astype(np.complex128)) * n if args.inverse
              else np.fft.fft(x.astype(np.complex128)))
    ordered = bool(args.reorder)
    if args.inverse:
        def fn(a):  # reference contract: unnormalized inverse
            return api.ifft(a, ordered=ordered, precision=prec, norm=None)
    else:
        def fn(a):
            return api.fft(a, ordered=ordered, precision=prec)

    def compare(got, tol):
        c = max(1, n // 128)
        if not ordered and c > 1:
            # revblock -> natural (the reference leaves this mode
            # unverified, FFT.c:161-163; the layout is fixed, so verify it)
            got = got.reshape(n_ffts, c, 128).transpose(0, 2, 1).reshape(
                n_ffts, n)
        return native.compare(got, golden.astype(np.complex64), tol)
    return x, fn, compare


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from smfft_tpu_torch.config import flags

    if args.device == "cuda" and not torch.cuda.is_available():
        print("verify: no CUDA device (torch.cuda.is_available() is false); "
              "this harness runs the GPU kernels and will not fall back to "
              "the CPU.  Pass --device cpu to run the plain versions on the "
              "CPU.", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    n, n_ffts = args.fft_size, args.n_ffts
    core = n if args.kind == "c2c" else n // 2
    pack = max(1, 128 // max(core, 1))
    if n_ffts % pack:
        n_ffts += pack - n_ffts % pack
        print(f"nFFTs rounded up to {n_ffts} (multiple of {pack})")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain PyTorch version)")
    print(f"device: {kind}, kind={args.kind}, N={n}, nFFTs={n_ffts}, "
          f"runs={args.n_runs}, inverse={args.inverse}, "
          f"reorder={args.reorder}, precision={args.precision}")

    x, fn, compare = _inputs(args, n, n_ffts)
    xd = torch.from_numpy(x).to(device)
    out, times = _timed_runs(fn, xd, args.n_runs, device)
    got = out.cpu().numpy()

    mean_ms, med_ms = float(np.mean(times)), float(np.median(times))
    runs = ", ".join(f"{t:.4f}" for t in times)
    if device.type == "cuda":
        # bytes read and written: 16 per complex point, 8 per real sample
        per_point = 16.0 if args.kind == "c2c" else 8.0
        gbs = per_point * n_ffts * n / (med_ms * 1e-3) / 1e9
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
    stats = compare(got, args.tolerance)
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
