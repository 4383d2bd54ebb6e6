"""Time the C2C, R2C, reuse, convolution, Bluestein and huge-N paths of
one or more checkouts of smfft_tpu_torch on one GPU, in turns, so that two
versions are compared on the same card in one run.

    python -m smfft_tpu_torch.c2c_ab PARENT_ROOT . . PARENT_ROOT

Each root runs in its own process (each builds its own kernels), with
about 2^27 complex points or real samples per call, precision "highest":

  * ``fft`` and ``planar.fft`` at N = 1024, 4096, 16384, the median of 25
    (``fft``) or 15 CUDA-event-timed calls after a warm-up, beside a
    same-run ``copy_`` of the same bytes and ``torch.fft.fft``;
  * ``planar.rfft`` and ``rfft`` (numpy layout) at n = 1024, 4096, 16384,
    the median of 15, beside a same-run ``copy_`` of the real bytes and
    ``torch.fft.rfft``; ``planar.irfft`` and ``irfft`` (numpy layout) of
    their spectra beside ``torch.fft.irfft``, and the C2R kernel alone
    (``c2r_kernel_ms``: ten launches of ``smfft_c2r`` on the planar
    spectrum between two events, the tables made once);
  * ``fft_any`` at n = 1000 (131072 rows) and 4097 (32768 rows), and
    ``fft_large`` at N = 2^15, 2^20, 2^24, 2^27, the median of 15;
  * the reuse loops at 100 transforms a call: ``fft_planar(
    multiple_iters=100)`` at N = 1024, 4096, 16384,
    ``multiple_pencil_planar(iters=100)`` and
    ``multiple_real_pencil_planar(iters=100)`` at 1024 and 4096, the median
    of 5, beside the same root's single-pass calls on the same shape
    (``planar.fft``; ``planar.rfft`` and ``planar.irfft`` for a real pair)
    and the ratio of 100 single transforms to one reuse call;
  * the fused convolutions: ``convolve`` at N = 1024, 4096, 16384 and a
    4-filter bank at 1024, ``convolve_real`` at n = 1024, 4096, 16384 and a
    4-filter bank at 1024 (2^27 points or samples), and ``fftconvolve`` of
    64 real streams of 2^21 samples with 129 taps, the median of 15 (7 for
    ``fftconvolve``), each beside a same-run ``copy_`` of its input and
    the ``torch.fft`` composition (``fft``, multiply, ``ifft``; the same
    overlap-save framing around ``rfft`` / ``irfft``); and the kernels
    alone on the same shapes (``*_kernel_ms``: ten launches of the
    library's entry point between two events, the tables made once, so
    that the wrappers' host work between calls drops out);
  * the fp32 error of ``fft`` / ``ifft`` and ``convolve`` (64 rows, every
    N) and of ``rfft``, ``irfft`` and ``convolve_real`` (64 rows, every n)
    against float64 ``torch.fft``, in ulp(max|X|) (max|x| for ``irfft``,
    max|y| for a convolution).

Prints one JSON line per root and the registers and spills ptxas gave each
instantiation of the kernels both roots build the same way (power, huge-N
real, and the kernels already on the Hopper core hcore.cuh before the C2R
kernel: C2C, R2C, Bluestein, the four-step pass and the reuse loops) in
that root's build, whether those are the same in every root, then the
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from smfft_tpu_torch.ops._cuda import register_report

# the kernel instantiations whose registers and spills are compared
SHARED_KERNELS = ("power_kernel", "real_huge_kernel",
                  "bluestein_kernel", "fourstep_pass_kernel", "c2c_kernel",
                  "r2c_kernel", "c2c_multiple_kernel",
                  "real_multiple_kernel")

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
       "ulp_fp32": {"fft": {}, "rfft": {}, "irfft": {}, "convolve": {},
                    "convolve_real": {}}}
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
from smfft_tpu_torch.ops import c2c as OC
from smfft_tpu_torch.ops import multiple as OM
from smfft_tpu_torch.ops import real as OR
lib = _cuda.library()
stream = torch.cuda.current_stream().cuda_stream
def kernel_ms(launch, k=10):
    return ms(lambda: [launch() for _ in range(k)]) / k
def c2r_kernel_ms(hr, hi, n):
    y = torch.empty((hr.shape[0], n), device="cuda")
    tw = OC.device_twiddles(n // 2, True, False, hr.device)
    wn = OR.split_table(n, False, hr.device)
    return kernel_ms(lambda: lib.smfft_c2r(
        hr.data_ptr(), hi.data_ptr(), 0, y.data_ptr(), hr.shape[0], n,
        2.0 / n, tw.data_ptr(), wn.data_ptr(), 0, stream))
for n in (1024, 4096, 16384):
    x = torch.rand(((1 << 27) // n, n), generator=gen, device="cuda") - 0.5
    dst = torch.empty_like(x)
    row = {"n": n, "planar_rfft_ms": ms(lambda: T.planar.rfft(x)),
           "rfft_ms": ms(lambda: T.rfft(x)),
           "copy_real_ms": ms(lambda: dst.copy_(x)),
           "torch_rfft_ms": ms(lambda: torch.fft.rfft(x))}
    hr, hi = T.planar.rfft(x)
    spec = T.rfft(x)
    row.update({"planar_irfft_ms": ms(lambda: T.planar.irfft(hr, hi)),
                "irfft_ms": ms(lambda: T.irfft(spec, n)),
                "c2r_kernel_ms": c2r_kernel_ms(hr, hi, n),
                "torch_irfft_ms": ms(lambda: torch.fft.irfft(spec, n))})
    out["rows"].append(row)
    del x, dst, hr, hi, spec
    torch.cuda.empty_cache()
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
from smfft_tpu_torch.ops import convolve as OV
def conv_kernel_ms(x, h, n):
    o = torch.empty((h.shape[0],) + tuple(x.shape), dtype=x.dtype,
                    device="cuda")
    hd = OV.device_response(h, 1.0 / n, False, x.device)
    tw = [OC.device_twiddles(n, i, False, x.device) for i in (False, True)]
    return kernel_ms(lambda: lib.smfft_conv(
        x.data_ptr(), None, o.data_ptr(), None, 1, x.shape[0], n,
        h.shape[0], hd.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(), 0,
        stream))
def conv_real_kernel_ms(x, h, n):
    o = torch.empty((h.shape[0],) + tuple(x.shape), device="cuda")
    hd = OV.device_response(OV.pack_real_response(h), 2.0 / n, False,
                            x.device)
    tw = [OC.device_twiddles(n // 2, i, False, x.device)
          for i in (False, True)]
    wn = OR.split_table(n, False, x.device)
    return kernel_ms(lambda: lib.smfft_conv_real(
        x.data_ptr(), o.data_ptr(), x.shape[0], n, h.shape[0],
        hd.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(), wn.data_ptr(), 0,
        stream))
for n in (1024, 4096, 16384):
    b = (1 << 27) // n
    x = torch.complex(torch.rand((b, n), generator=gen, device="cuda"),
                      torch.rand((b, n), generator=gen, device="cuda"))
    h = torch.complex(torch.rand((4, n), generator=gen, device="cuda"),
                      torch.rand((4, n), generator=gen, device="cuda"))
    dst = torch.empty_like(x)
    row = {"n": n, "convolve_ms": ms(lambda: T.convolve(x, h[0])),
           "conv_kernel_ms": conv_kernel_ms(x, h[:1], n),
           "copy_ms": ms(lambda: dst.copy_(x)),
           "torch_composition_ms": ms(
               lambda: torch.fft.ifft(torch.fft.fft(x) * h[0]))}
    if n == 1024:
        row["convolve_bank4_ms"] = ms(lambda: T.convolve(x, h))
        row["conv_kernel_bank4_ms"] = conv_kernel_ms(x, h, n)
        row["torch_composition_bank4_ms"] = ms(
            lambda: torch.fft.ifft(torch.fft.fft(x)[None] * h[:, None]))
    out["rows"].append(row)
    del x, dst
    torch.cuda.empty_cache()
    x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    h = torch.fft.rfft(torch.rand((4, n), generator=gen, device="cuda")
                       - 0.5).to(torch.complex64)
    dst = torch.empty_like(x)
    row = {"n": n, "convolve_real_ms": ms(lambda: T.convolve_real(x, h[0])),
           "conv_real_kernel_ms": conv_real_kernel_ms(x, h[:1], n),
           "copy_real_ms": ms(lambda: dst.copy_(x)),
           "torch_composition_real_ms": ms(lambda: torch.fft.irfft(
               torch.fft.rfft(x) * h[0], n))}
    if n == 1024:
        row["convolve_real_bank4_ms"] = ms(lambda: T.convolve_real(x, h))
        row["conv_real_kernel_bank4_ms"] = conv_real_kernel_ms(x, h, n)
        row["torch_composition_real_bank4_ms"] = ms(
            lambda: torch.fft.irfft(torch.fft.rfft(x)[None] * h[:, None], n))
    out["rows"].append(row)
    del x, dst
    torch.cuda.empty_cache()
# overlap-save: 64 real streams of 2^21 samples, 129 taps (n_fft = 512)
x = torch.rand((64, 1 << 21), generator=gen, device="cuda") - 0.5
taps = torch.rand(129, generator=gen, device="cuda") - 0.5
def framed_torch_fft(x, taps, nf=512):
    k, t = taps.shape[-1], x.shape[-1]
    hop, full = nf - k + 1, t + k - 1
    fr = -(-full // hop)
    xp = torch.nn.functional.pad(x, (k - 1, (fr - 1) * hop + nf - (k - 1) - t))
    fx = xp.unfold(-1, nf, hop).reshape(-1, nf)
    y = torch.fft.irfft(torch.fft.rfft(fx) * torch.fft.rfft(taps, nf), nf)
    return y.reshape(x.shape[0], fr, nf)[:, :, k - 1:].reshape(
        x.shape[0], fr * hop)[:, :full]
dst = torch.empty_like(x)
out["rows"].append({"fftconvolve_ms": ms(lambda: T.fftconvolve(x, taps), 7),
                    "copy_real_ms": ms(lambda: dst.copy_(x), 7),
                    "torch_composition_ms": ms(
                        lambda: framed_torch_fft(x, taps), 7)})
del x, dst
torch.cuda.empty_cache()
for n in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
    # both parts centred: a DC bin of N/2 would set max|X| for every kernel
    x = torch.complex(torch.rand((64, n), generator=gen, device="cuda") - 0.5,
                      torch.rand((64, n), generator=gen, device="cuda") - 0.5)
    x64 = x.to(torch.complex128)
    out["ulp_fp32"]["fft"][n] = max(
        ulps(T.fft(x), torch.fft.fft(x64)),
        ulps(T.ifft(x), torch.fft.ifft(x64)))
    h = torch.complex(torch.rand(n, generator=gen, device="cuda") - 0.5,
                      torch.rand(n, generator=gen, device="cuda") - 0.5)
    out["ulp_fp32"]["convolve"][n] = ulps(
        T.convolve(x, h), torch.fft.ifft(torch.fft.fft(x64)
                                         * h.to(torch.complex128)))
    if 2 * n <= 16384:
        xr = torch.cat([x.real, x.imag], dim=1)
        out["ulp_fp32"]["rfft"][2 * n] = ulps(
            T.rfft(xr), torch.fft.rfft(xr.double()))
        spec = torch.fft.rfft(xr.double()).to(torch.complex64)
        out["ulp_fp32"]["irfft"][2 * n] = ulps(
            T.irfft(spec, 2 * n),
            torch.fft.irfft(spec.to(torch.complex128), 2 * n))
        if 2 * n >= 256:
            hr = torch.fft.rfft(torch.cat([h.real, h.imag]).double())
            out["ulp_fp32"]["convolve_real"][2 * n] = ulps(
                T.convolve_real(xr, hr.to(torch.complex64)),
                torch.fft.irfft(torch.fft.rfft(xr.double()) * hr, 2 * n))
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
    print(f"power / real_huge / bluestein / fourstep_pass / c2c / r2c / "
          f"c2c_multiple / real_multiple instantiations report the same "
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
