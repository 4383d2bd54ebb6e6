#!/usr/bin/env python
"""GPU smoke run of smfft_tpu_torch: builds the kernels, checks them, and
drives the C2C and the real main paths at the working size on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero at once):
  1. Card details and the kernel build from ``smfft_tpu_torch/csrc`` (one
     nvcc per source, all started together).
  2. C2C sweep: the kernel against its plain PyTorch version and against
     the float64 ``torch.fft`` oracle, every N x forward/inverse x
     {ordered, revblock out, revblock in} x {complex64, planar} x tiers
     {"highest", "exact"}, ~2^22 points per call, within 2e-7 * N^0.75 * 8;
     "exact" must also stay within 2 ulp of max|X| of the oracle.
  3. Real sweep: the R2C kernel in its 4 output layouts and the C2R kernel
     in its 4 input layouts against their plain versions and against
     float64 ``torch.fft.rfft`` / ``irfft``, every real n x tiers, ~2^22
     samples per call, with the same bounds.
  4. The C2C main path at 2^27 points per call (512 MB per fp32 plane):
     ``fft`` and ``planar.fft`` / ``planar.ifft`` at N = 1024, 4096, 16384
     and the ``fft(ordered=False)`` -> ``ifft_unordered`` round trip at
     N = 1024.  Median of CUDA-event-timed repetitions, GB/s counted in+out
     (16 bytes per complex point), beside a same-run ``copy_`` of the same
     bytes, the plain version, ``torch.fft.fft`` and the "exact" tier.
     Every row of every output is checked against the plain version on the
     same input, and a subset of rows against the float64 oracle; one
     ``fft(precision="exact")`` call per N is held, every row, against the
     plain version computed in float64, and its first rows within 2 ulp of
     max|X| of the oracle.
  5. The real main path at 2^27 real samples per call (512 MB fp32 input
     plane): ``rfft``, ``fft_packed_real``, ``planar.rfft`` and
     ``planar.irfft`` (both tiers) at n = 1024, 4096, 16384 and the
     ``planar.rfft(ordered=False)`` -> ``planar.irfft(in_natural=False)``
     round trip at n = 1024, checked and timed the same way (GB/s counted
     as 8 bytes per real sample) beside ``torch.fft.rfft`` / ``irfft``.
  Before each main path every launch counter is set to 0; right after, each
     kernel's counter must equal its number of calls on that path (and the
     other path's kernels must not have run).
  6. ``smfft_tpu_torch.verify`` 1024 4096 2 0 1, and 4096 4096 2 with
     ``--kind r2c`` and ``--kind c2r``, print PASSED.

The last lines are the card, a JSON line of kernel results and the device
line.
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
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bandwidth and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(n: int) -> float:
    """The error bound the TPU kernels met on their chip."""
    return 2e-7 * n ** 0.75 * 8


def ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 23)


def least_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def max_err(a, b) -> float:
    """max |a - b| over tensors or tuples of planes."""
    if isinstance(a, tuple):
        return max(max_err(u, v) for u, v in zip(a, b))
    return (a.to(torch.complex128) - b.to(torch.complex128)).abs().max().item()


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


def reset_counts() -> None:
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import real as R
    C.launch.count = R.launch_r2c.count = R.launch_c2r.count = 0


def counts() -> dict:
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import real as R
    return {"c2c": C.launch.count, "r2c": R.launch_r2c.count,
            "c2r": R.launch_c2r.count}


def check_counts(path: str, expected: dict) -> dict:
    got = counts()
    print(f"launch counters over the {path} main path: {got} (expected "
          f"{expected})")
    if got != expected or not any(got.values()):
        fail(f"the {path} main path did not go through its kernels once "
             "per call")
    return got


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
    for line in _cuda.register_report():
        print(f"  ptxas: {line}")
    return name, card


def phase_sweep():
    """C2C kernel vs plain version vs float64 oracle at every size, mode
    and tier; returns (max |kernel - plain|, worst "exact" ulp)."""
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_plain, worst_ulp, worst_exact = 0.0, 0.0, 0.0
    modes = (("ordered", False, False), ("rev_out", False, True),
             ("rev_in", True, False))
    for n in SUPPORTED_C2C_SIZES:
        b = SWEEP_POINTS // n
        x = rand_complex(b, n, gen)
        for inverse in (False, True):
            want = oracle(x[:ORACLE_ROWS], inverse)
            max_ulp = ulp(want.abs().max().item())
            for exact in (False, True):
                e_plain = e_orc = 0.0
                for mode, rev_in, rev_out in modes:
                    kw = dict(inverse=inverse, rev_in=rev_in,
                              rev_out=rev_out, exact=exact)
                    xin = to_revblock(x) if rev_in else x
                    w = to_revblock(want) if rev_out else want
                    plain = torch.complex(*C.plain(xin.real, xin.imag, **kw))
                    got_c = C.launch(xin.contiguous(), **kw)
                    gr, gi = C.launch(xin.real.contiguous(),
                                      xin.imag.contiguous(), **kw)
                    torch.cuda.synchronize()
                    for got in (got_c, torch.complex(gr, gi)):
                        e_plain = max(e_plain, max_err(got, plain))
                        e_orc = max(e_orc, max_err(got[:ORACLE_ROWS], w))
                tier = "exact" if exact else "highest"
                print(f"N={n:5d} {'inv' if inverse else 'fwd'} {tier:7s} "
                      f"(3 layouts x complex/planar): vs plain "
                      f"{e_plain:.3e} vs oracle {e_orc:.3e} "
                      f"({e_orc / max_ulp:.2f} ulp) bound {bound(n):.3e}")
                if not (e_plain <= bound(n) and e_orc <= bound(n)):
                    fail(f"N={n} inverse={inverse} {tier}: error over bound")
                if exact and not e_orc <= 2 * max_ulp:
                    fail(f"N={n} inverse={inverse}: the 'exact' tier is "
                         f"{e_orc / max_ulp:.2f} ulp(max|X|) from the "
                         "oracle, over its contract of 2")
                worst_plain = max(worst_plain, e_plain)
                if exact:
                    worst_exact = max(worst_exact, e_orc / max_ulp)
                else:
                    worst_ulp = max(worst_ulp, e_orc / max_ulp)
        del x
    print(f"C2C sweep: max |kernel - plain| {worst_plain:.3e}; max oracle "
          f"error 'highest' {worst_ulp:.2f} ulp(max|X|), 'exact' "
          f"{worst_exact:.2f} (contract <= 2)")
    return worst_plain, worst_exact


def phase_real_sweep():
    """Both real kernels in every layout vs their plain versions and the
    float64 oracle, at every real n and both tiers; returns the max
    |kernel - plain| of each kernel and the worst "exact" ulp."""
    from smfft_tpu_torch.ops import real as R
    from smfft_tpu_torch.params import SUPPORTED_REAL_SIZES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"r2c": 0.0, "c2r": 0.0}
    worst_exact = 0.0
    for n in SUPPORTED_REAL_SIZES:
        L = n // 2
        b = SWEEP_POINTS // n + 3  # ragged against every rows-per-block
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        want = torch.fft.rfft(x[:ORACLE_ROWS].double())
        u_fwd = ulp(want.abs().max().item())
        # the C2R input: numpy's spectrum of x, rounded to fp32, in every
        # layout; its oracle is the float64 irfft of that same spectrum
        spec = torch.fft.rfft(x.double()).to(torch.complex64)
        back = torch.fft.irfft(spec[:ORACLE_ROWS].to(torch.complex128), n)
        u_inv = ulp(back.abs().max().item())
        natural = [t.contiguous()
                   for t in R.from_layout(spec, None, "numpy", L)]
        for exact in (False, True):
            tier = "exact" if exact else "highest"
            for layout in R.LAYOUTS:
                got = R.launch_r2c(x, layout, exact)
                plain = R.r2c_plain(x, layout, exact)
                e_r2c = max_err(got, plain)
                pr, pi = R.from_layout(*(got if isinstance(got, tuple)
                                         else (got, None)), layout, L)
                nat = R.to_layout(pr[:ORACLE_ROWS], pi[:ORACLE_ROWS],
                                  "numpy")
                o_r2c = max_err(nat, want)
                src = R.to_layout(*natural, layout)
                args = tuple(t.contiguous() for t in (
                    src if isinstance(src, tuple) else (src,)))
                y = R.launch_c2r(*args, n=n, layout=layout, scale=1.0 / L,
                                 exact=exact)
                yp = R.c2r_plain(*args, n=n, layout=layout, scale=1.0 / L,
                                 exact=exact)
                torch.cuda.synchronize()
                e_c2r = max_err(y, yp)
                o_c2r = max_err(y[:ORACLE_ROWS], back)
                print(f"n={n:5d} {tier:7s} {layout:10s}: r2c vs plain "
                      f"{e_r2c:.3e} vs oracle {o_r2c:.3e} "
                      f"({o_r2c / u_fwd:.2f} ulp) | c2r vs plain "
                      f"{e_c2r:.3e} vs oracle {o_c2r:.3e} "
                      f"({o_c2r / u_inv:.2f} ulp) | bound {bound(n):.3e}")
                if max(e_r2c, o_r2c, e_c2r, o_c2r) > bound(n):
                    fail(f"real n={n} {tier} {layout}: error over bound")
                if exact and (o_r2c > 2 * u_fwd or o_c2r > 2 * u_inv):
                    fail(f"real n={n} {layout}: the 'exact' tier is over "
                         "2 ulp of the oracle")
                worst["r2c"] = max(worst["r2c"], e_r2c)
                worst["c2r"] = max(worst["c2r"], e_c2r)
                if exact:
                    worst_exact = max(worst_exact, o_r2c / u_fwd,
                                      o_c2r / u_inv)
        del x, spec
    print(f"real sweep: max |kernel - plain| r2c {worst['r2c']:.3e}, c2r "
          f"{worst['c2r']:.3e}; 'exact' at most {worst_exact:.2f} ulp")
    return worst, worst_exact


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


def check_all(y, plain, n: int, what: str) -> float:
    """Every row of y (a tensor or a planar pair) against the plain
    version's output on the same input; returns the max abs error."""
    first = y[0] if isinstance(y, tuple) else y
    finite = all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex()
                                     else t).all())
                 for t in (y if isinstance(y, tuple) else (y,)))
    if not finite:
        fail(f"{what}: non-finite output")
    err = max_err(y, plain)
    print(f"  {what}: all {first.shape[0]} rows vs plain {err:.3e} "
          f"(bound {bound(n):.3e})")
    if not err <= bound(n):
        fail(f"{what}: error {err:.3e} against the plain version over bound")
    return err


def check_ulp(head, want: torch.Tensor, what: str) -> float:
    """The "exact" tier's contract: head, the first ORACLE_ROWS rows of an
    output, within 2 ulp(max|X|) of the float64 oracle's rows want."""
    e = max_err(head, want) / ulp(want.abs().max().item())
    print(f"  {what}: first {ORACLE_ROWS} rows {e:.2f} ulp(max|X|) from "
          "float64 (contract <= 2)")
    if not e <= 2:
        fail(f"{what}: the 'exact' tier is {e:.2f} ulp(max|X|) from the "
             "oracle, over its contract of 2")
    return e


def phase_main(card: str):
    """The C2C main path at 2^27 points per call; returns (rows, calls,
    err): err is the largest error of a main-path output against the
    plain version, over every row."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import c2c as C
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, calls, worst = [], 0, 0.0
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
        worst = max(worst, check_all(y, fwd, n, f"fft N={n}"))
        del y
        o = T.planar.fft(xr, xi)
        calls += 1
        y = torch.complex(*o)
        check_rows(y, x, False, None, f"planar.fft N={n}")
        worst = max(worst, check_all(y, fwd, n, f"planar.fft N={n}"))
        del o, y
        if n == 1024:
            u = T.fft(x, ordered=False)
            back = T.ifft_unordered(u)
            calls += 2
            worst = max(worst, check_all(u, to_revblock(fwd), n,
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
        worst = max(worst, check_all(y, inv, n, f"planar.ifft N={n}"))
        del o, y, inv
        # the "exact" tier at this size: every row against the plain
        # version computed in float64, the first rows against the oracle
        y = T.fft(x, precision="exact")
        calls += 1
        worst = max(worst, check_all(
            y, torch.complex(*C.plain(xr, xi, exact=True)), n,
            f"fft exact N={n}"))
        check_ulp(y[:ORACLE_ROWS], oracle(x[:ORACLE_ROWS], False),
                  f"fft exact N={n}")
        del y

        ms_fft = cuda_ms(lambda: T.fft(x))
        calls += 1 + REPS
        ms_exact = cuda_ms(lambda: T.fft(x, precision="exact"))
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
        # 16 bytes per point; ~5 N log2 N flops per transform
        bound_ms, bound_by = least_ms(16.0 * MAIN_POINTS,
                                      5.0 * MAIN_POINTS * math.log2(n))
        row = {"n": n, "batch": b, "fft_ms": ms_fft,
               "fft_exact_ms": ms_exact, "planar_fft_ms": ms_pfft,
               "planar_ifft_ms": ms_pifft, "roundtrip_ms": ms_rt,
               "copy_ms": ms_copy, "plain_ms": ms_plain,
               "torch_fft_ms": ms_torch, "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        print(f"N={n:5d} batch={b} ({card}): "
              f"fft {ms_fft:.4f} ms = {gb / ms_fft * 1e3:.1f} GB/s | "
              f"fft exact {ms_exact:.4f} ms | "
              f"planar.fft {ms_pfft:.4f} ms = {gb / ms_pfft * 1e3:.1f} GB/s | "
              f"planar.ifft {ms_pifft:.4f} ms = "
              f"{gb / ms_pifft * 1e3:.1f} GB/s | "
              f"copy_ {ms_copy:.4f} ms = {gb / ms_copy * 1e3:.1f} GB/s | "
              f"plain {ms_plain:.4f} ms | torch.fft {ms_torch:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by})"
              + (f" | round trip {ms_rt:.4f} ms" if ms_rt else ""))
        print(f"  fft at {ms_copy / ms_fft:.3f} of the copy roofline; "
              f"planar.fft at {ms_copy / ms_pfft:.3f}")
        del x, xr, xi
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


def phase_main_real(card: str):
    """The real main path at 2^27 real samples per call; returns (rows,
    r2c calls, c2r calls, {kernel: worst error against the plain version
    over every row})."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import real as R
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows, n_r2c, n_c2r = [], 0, 0
    worst = {"r2c": 0.0, "c2r": 0.0}
    gb = 8.0 * MAIN_POINTS / 1e9  # 4 bytes in and 4 out per real sample
    for n in MAIN_SIZES:
        L, b = n // 2, MAIN_POINTS // n
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        # the plain version at the main path's own shapes (no launches)
        p_planar = R.r2c_plain(x, "planar")

        y = T.rfft(x)
        n_r2c += 1
        want = torch.fft.rfft(x[:ORACLE_ROWS].double())
        if max_err(y[:ORACLE_ROWS], want) > bound(n):
            fail(f"rfft n={n}: rows against float64 over bound")
        worst["r2c"] = max(worst["r2c"], check_all(
            y, R.to_layout(*p_planar, "numpy"), n, f"rfft n={n}"))
        del y
        y = T.fft_packed_real(x)
        n_r2c += 1
        worst["r2c"] = max(worst["r2c"], check_all(
            y, R.to_layout(*p_planar, "packed"), n,
            f"fft_packed_real n={n}"))
        del y
        hr, hi = T.planar.rfft(x)
        n_r2c += 1
        worst["r2c"] = max(worst["r2c"], check_all(
            (hr, hi), p_planar, n, f"planar.rfft n={n}"))
        del p_planar
        back = T.planar.irfft(hr, hi)
        n_c2r += 1
        worst["c2r"] = max(worst["c2r"], check_all(
            back, R.c2r_plain(hr, hi, n=n, scale=1.0 / L), n,
            f"planar.irfft n={n}"))
        err = (back - x).abs().max().item()
        print(f"  planar.rfft -> planar.irfft round trip: max |x' - x| "
              f"{err:.3e}")
        if err > bound(n):
            fail("real round trip over bound")
        del back
        # the "exact" tier at this size, as in phase_main
        er, ei = T.planar.rfft(x, precision="exact")
        n_r2c += 1
        worst["r2c"] = max(worst["r2c"], check_all(
            (er, ei), R.r2c_plain(x, "planar", exact=True), n,
            f"planar.rfft exact n={n}"))
        check_ulp(R.to_layout(er[:ORACLE_ROWS], ei[:ORACLE_ROWS], "numpy"),
                  want, f"planar.rfft exact n={n}")
        del er, ei
        back = T.planar.irfft(hr, hi, precision="exact")
        n_c2r += 1
        worst["c2r"] = max(worst["c2r"], check_all(
            back, R.c2r_plain(hr, hi, n=n, scale=1.0 / L, exact=True), n,
            f"planar.irfft exact n={n}"))
        spec = R.to_layout(hr[:ORACLE_ROWS].double(),
                           hi[:ORACLE_ROWS].double(), "numpy")
        check_ulp(back[:ORACLE_ROWS], torch.fft.irfft(spec, n),
                  f"planar.irfft exact n={n}")
        del back, spec
        if n == 1024:
            ur, ui = T.planar.rfft(x, ordered=False)
            n_r2c += 1
            worst["r2c"] = max(worst["r2c"], check_all(
                (ur, ui), R.to_layout(hr, hi, "planar_rev"), n,
                f"planar.rfft(ordered=False) n={n}"))
            back = T.planar.irfft(ur, ui, in_natural=False)
            n_c2r += 1
            worst["c2r"] = max(worst["c2r"], check_all(
                back, R.c2r_plain(ur, ui, n=n, layout="planar_rev",
                                  scale=1.0 / L), n,
                f"planar.irfft(in_natural=False) n={n}"))
            err = (back - x).abs().max().item()
            print(f"  planar.rfft(ordered=False) -> planar.irfft("
                  f"in_natural=False) round trip: max |x' - x| {err:.3e}")
            if err > bound(n):
                fail("revblock real round trip over bound")
            del ur, ui, back

        ms_rfft = cuda_ms(lambda: T.rfft(x))
        ms_packed = cuda_ms(lambda: T.fft_packed_real(x))
        ms_prfft = cuda_ms(lambda: T.planar.rfft(x))
        ms_prfft_exact = cuda_ms(lambda: T.planar.rfft(x, precision="exact"))
        n_r2c += 4 * (1 + REPS)
        ms_pirfft = cuda_ms(lambda: T.planar.irfft(hr, hi))
        ms_pirfft_exact = cuda_ms(
            lambda: T.planar.irfft(hr, hi, precision="exact"))
        n_c2r += 2 * (1 + REPS)
        if n == 1024:
            ms_rt = cuda_ms(lambda: T.planar.irfft(
                *T.planar.rfft(x, ordered=False), in_natural=False))
            n_r2c += 1 + REPS
            n_c2r += 1 + REPS
        else:
            ms_rt = None

        # references at the same shapes (no kernel launches)
        dst = torch.empty_like(x)
        ms_copy = cuda_ms(lambda: dst.copy_(x))
        del dst
        ms_plain_r2c = cuda_ms(lambda: R.r2c_plain(x), reps=3)
        ms_plain_c2r = cuda_ms(lambda: R.c2r_plain(hr, hi, n=n), reps=3)
        ms_torch_rfft = cuda_ms(lambda: torch.fft.rfft(x))
        spec = torch.fft.rfft(x)
        ms_torch_irfft = cuda_ms(lambda: torch.fft.irfft(spec, n))
        del spec
        # 8 bytes per real sample; ~2.5 n log2 n + 5 n flops a row
        bound_ms, bound_by = least_ms(
            8.0 * MAIN_POINTS, MAIN_POINTS * (2.5 * math.log2(n) + 5.0))
        row = {"n": n, "batch": b, "rfft_ms": ms_rfft,
               "fft_packed_real_ms": ms_packed, "planar_rfft_ms": ms_prfft,
               "planar_rfft_exact_ms": ms_prfft_exact,
               "planar_irfft_ms": ms_pirfft,
               "planar_irfft_exact_ms": ms_pirfft_exact,
               "roundtrip_ms": ms_rt, "copy_ms": ms_copy,
               "plain_r2c_ms": ms_plain_r2c, "plain_c2r_ms": ms_plain_c2r,
               "torch_rfft_ms": ms_torch_rfft,
               "torch_irfft_ms": ms_torch_irfft, "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        print(f"n={n:5d} batch={b} ({card}): "
              f"rfft {ms_rfft:.4f} ms = {gb / ms_rfft * 1e3:.1f} GB/s | "
              f"fft_packed_real {ms_packed:.4f} | "
              f"planar.rfft {ms_prfft:.4f} ms = "
              f"{gb / ms_prfft * 1e3:.1f} GB/s (exact {ms_prfft_exact:.4f}) | "
              f"planar.irfft {ms_pirfft:.4f} ms = "
              f"{gb / ms_pirfft * 1e3:.1f} GB/s (exact "
              f"{ms_pirfft_exact:.4f}) | copy_ {ms_copy:.4f} ms = "
              f"{gb / ms_copy * 1e3:.1f} GB/s | plain r2c {ms_plain_r2c:.4f} "
              f"c2r {ms_plain_c2r:.4f} | torch.fft.rfft "
              f"{ms_torch_rfft:.4f} irfft {ms_torch_irfft:.4f} | bound "
              f"{bound_ms:.4f} ms ({bound_by})"
              + (f" | round trip {ms_rt:.4f} ms" if ms_rt else ""))
        print(f"  planar.rfft at {ms_copy / ms_prfft:.3f} of the copy "
              f"roofline; planar.irfft at {ms_copy / ms_pirfft:.3f}")
        del x, hr, hi
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, n_r2c, n_c2r, worst


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
    worst_c2c, _ = phase_sweep()
    worst_real, _ = phase_real_sweep()

    reset_counts()
    rows, calls, worst_main = phase_main(card)
    c2c_counts = check_counts("C2C", {"c2c": calls, "r2c": 0, "c2r": 0})

    reset_counts()
    real_rows, n_r2c, n_c2r, worst_real_main = phase_main_real(card)
    real_counts = check_counts("real",
                               {"c2c": 0, "r2c": n_r2c, "c2r": n_c2r})

    from smfft_tpu_torch import verify
    for argv in (["1024", "4096", "2", "0", "1"],
                 ["4096", "4096", "2", "--kind", "r2c"],
                 ["4096", "4096", "2", "--kind", "c2r"]):
        if verify.main(argv) != 0:
            fail(f"verify {' '.join(argv)} did not pass")
    if "jax" in sys.modules:
        fail("jax was imported")

    main_row, real_row = rows[0], real_rows[0]
    print("main path rows: " + json.dumps({"card": card, "c2c": rows,
                                           "real": real_rows}))
    print("c2c also replaces smfft_tpu/ops/pencil.py:206 (iters = 1); r2c "
          "also pencil.py:387, real_direct.py:309,131; c2r also "
          "pencil.py:387, real_direct.py:592,745,491.  ms, plain_ms, "
          f"bound_ms and library_ms are at N = n = {main_row['n']} with "
          "2^27 points or samples: c2c = fft vs torch.fft.fft, r2c = "
          "planar.rfft vs torch.fft.rfft, c2r = planar.irfft vs "
          "torch.fft.irfft")
    kernels = [
        {"name": "c2c", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/c2c.cu",
         "replaces": "smfft_tpu/ops/pallas_c2c.py:1015",
         "launches": c2c_counts["c2c"],
         "max_abs_err": max(worst_c2c, worst_main),
         "ms": main_row["fft_ms"], "plain_ms": main_row["plain_ms"],
         "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
         "library_ms": main_row["torch_fft_ms"]},
        {"name": "r2c", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/real.cu",
         "replaces": "smfft_tpu/ops/pallas_real.py:270",
         "launches": real_counts["r2c"],
         "max_abs_err": max(worst_real["r2c"], worst_real_main["r2c"]),
         "ms": real_row["planar_rfft_ms"],
         "plain_ms": real_row["plain_r2c_ms"],
         "bound_ms": real_row["bound_ms"], "bound_by": real_row["bound_by"],
         "library_ms": real_row["torch_rfft_ms"]},
        {"name": "c2r", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/real.cu",
         "replaces": "smfft_tpu/ops/pallas_real.py:544",
         "launches": real_counts["c2r"],
         "max_abs_err": max(worst_real["c2r"], worst_real_main["c2r"]),
         "ms": real_row["planar_irfft_ms"],
         "plain_ms": real_row["plain_c2r_ms"],
         "bound_ms": real_row["bound_ms"], "bound_by": real_row["bound_by"],
         "library_ms": real_row["torch_irfft_ms"]},
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
