#!/usr/bin/env python
"""GPU smoke run of smfft_tpu_torch: builds the kernels, checks them, and
drives the C2C, real, reuse, convolution, spectral, arbitrary-length,
huge-N, N-D / DCT and parallel main paths and the acceleration plane at
the working size on one NVIDIA GPU.

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
     After the counters are read, the C2R kernel alone at n = 1024 (ten
     launches of the library's entry point between two events, the tables
     made once).
  6. ``smfft_tpu_torch.verify`` 1024 4096 2 0 1, and 4096 4096 2 with
     ``--kind r2c`` and ``--kind c2r``, print PASSED.
  7. Reuse sweep: ``c2c_multiple_kernel`` through
     ``fft_planar(multiple_iters=k)`` (both tiers, ordered and revblock
     out, k = 1, 3) against its plain version and float64 ``torch.fft``
     with the revblock map between steps; through
     ``multiple_pencil_planar`` (k = 1, 4; (F/sqrt N)^4 = I returns x);
     ``real_multiple_kernel`` through ``multiple_real_pencil_planar``
     (iters = 2, 4; returns x); every size, ~2^22 points a call.
  8. The reuse main path at 2^27 points with ITERS = 100 transforms held
     on chip (the reference's NREUSES): ``fft_planar(multiple_iters=100)``
     at N = 1024 / 4096 / 16384, ``multiple_pencil_planar`` and
     ``multiple_real_pencil_planar`` at 1024 / 4096.  The registers and
     spills of every reuse instantiation; the error after the loop's
     transforms against float64 (the pencil and real forms: against x)
     and its margin under the chained bound 2 bound(N) sqrt(ITERS + 1);
     MFFT/s (rows x iters / time), the bound (fp32 operations), and the
     ratio to 100 single calls (timed after the path's counters are
     read).
  9. Convolution sweep: the registers and spills of every instantiation
     of ``conv_kernel`` and ``conv_real_kernel``; ``conv_kernel``
     (complex64 and planar) and ``conv_real_kernel``, every size, both
     tiers, 1 and 3 filters (the single and the bank instantiations),
     against their plain versions and float64 ``torch.fft``; "exact"
     within 2 ulp of max|y|.
 10. The convolution main path at 2^27 points or samples: ``convolve`` at
     N = 1024 / 4096 / 16384 and a 4-filter bank at 1024,
     ``planar.convolve`` at 1024, ``convolve_real`` likewise, and
     ``fftconvolve`` of 64 real streams of 2^21 samples with 129 taps
     (n_fft = 512) and of complex streams of the same shape.  Time, GB/s,
     the same-run ``copy_``, the bound, the plain version and the
     ``torch.fft`` three-call composition; every row against the plain
     version, the first rows (every stream for ``fftconvolve``) against
     float64.
 11. Spectral sweep: ``power_kernel`` at n = 256..4096, with and without a
     hann window, against ``power_plain`` and float64 ``torch.fft.rfft``
     squared, within 2 bound(n) max|X| + bound(n)^2; the ``stft`` ->
     ``istft`` round trip, ``hilbert`` and ``welch`` on small inputs against
     float64.
 12. The spectral main path at 2^27 samples: ``power_spectrum`` with a hann
     window at n = 1024 and 4096, and ``welch`` / ``spectrogram`` of 64
     streams of 2^21 samples (nperseg 1024, noverlap 512).  Time, GB/s
     counted as 6 bytes a sample through the kernel, the same-run
     ``copy_``, the bound, the plain version and the composition
     ``torch.fft.rfft(x*w).abs().square()[..., :n//2]``; every row against
     the plain version, the first rows (stream) against float64.
 13. Bluestein sweep: ``fft_any``, ``ifft_any`` and ``planar.fft_any`` at n
     = 3, 100, 129, 1000, 1536, 4097, 6000, 8191, both tiers, against
     ``bluestein_plain`` and float64 ``torch.fft`` within bound(m) (m the
     convolution length); "exact" within 2 ulp of max|X|; the pad lanes of
     ``planar.fft_any`` exactly 0.
 14. The Bluestein main path at ~2^27 points: ``fft_any`` at n = 1000
     (131072 rows, m = 2048) and 4097 (32768 rows, m = 16384), ``ifft_any``
     and ``planar.fft_any`` at 1000, and ``resample`` of (131072, 1000)
     float32 rows to 768 samples (two Bluestein launches), beside
     ``torch.fft.fft`` / ``ifft`` at the same n; every row against the plain
     version (``resample``: against float64, scipy's semantics).
 15. Huge-N sweep: ``fourstep_pass_kernel`` through the default plan at N =
     2^15, 2^16, 2^17, 2^18, 2^20, 2^22, 2^24, 2^28 and the named plans
     "two:fold" and "three" at 2^20, "five" at 2^24 (complex64 and planar,
     forward and inverse with 1/N, both tiers), and the real transforms
     (the pair split in the last pass to radix 256, ``real_huge_kernel``'s
     other splits and the merges) through ``rfft_large`` / ``irfft_large``
     rows at n = 2^15, 2^20, 2^24 (pair and halfc) and 2^29 (halfc),
     against the plain versions and float64 ``torch.fft``; "exact" within
     2 ulp(max|X|).  Then the plan
     table: every plan's time at N = 2^18..2^28 with 2^27 points a call.
 16. The huge-N main path at 2^27 points or samples a call: ``fft_large``
     at N = 2^15 (4096 rows), 2^20 (128), 2^24 (8), 2^27 (1), ``ifft_large``
     and an "exact" ``fft_large`` at 2^20, ``planar.rfft_large`` /
     ``irfft_large`` at n = 2^20 (128 rows, pair) and 2^27 (1 row, halfc),
     one ``fft_large`` backward at 2^20, the JAX package's strided two-pass
     ``fft_large_planar(factors=(1024, 1024))`` at 2^20 (B22 + B23);
     beside the same-run ``copy_``, the
     plain version and ``torch.fft.fft`` / ``rfft`` / ``irfft``.  After the
     counters are read, the pair split alone at 2^27 samples, then the
     fused tail (``phase_fused_tail``): the pair-mode R2C of 2^30 samples a
     call at N = 2^21 .. 2^26, the main path (pass 1 and the fused tail
     where it fits, 2^21 .. 2^24) against ``pair_split_plan``'s three
     launches: ms, launches, the split items that waited, ``rfft_large_err``
     and ulp(max|X|) against float64 beside ROADMAP C.5's CPU figures.
 17. N-D / DCT sweep: ``fftn`` / ``ifftn`` over one (a middle), two and
     three axes, ``fft2`` / ``ifft2``, ``rfftn`` -> ``irfftn`` and ``rfft2``
     -> ``irfft2`` on (4, 64, 256) and (2, 32, 64, 128), ``hfft`` /
     ``ihfft`` with n = None / 256 / 1024 and three norms, ``dct`` /
     ``idct`` / ``dst`` / ``idst`` of types 1-4 at every supported n (types
     2, 3: 64..16384; DCT-I 33..8193; DST-I 31..8191; type 4: 16..8192) and
     both norms, ``dctn`` / ``idstn`` over two axes; each against the same
     call on a CPU copy (the plain versions) and float64 ``torch.fft`` /
     ``scipy.fft`` within the summed bound(m) * max|ref| (m each pass's
     kernel length); ``fft2(precision="exact")`` within 2 ulp(max|X|) an
     axis.
 18. The N-D / DCT main path at 2^27 points or samples a call: ``fft2`` /
     ``ifft2`` of (128, 1024, 1024) complex64 (a c2c launch and the column
     route's one pass each), ``fftn`` of one (8192, 16384) image (a c2c
     and two column passes), ``rfft2`` / ``irfft2``
     of (128, 1024, 1024) (r2c + c2c; c2c + c2r), ``dctn`` over the last
     two axes of it (2 r2c), ``rfftn`` of (512, 512, 512) (r2c + 2 c2c),
     ``hfft`` / ``ihfft`` at n = 1024, 131072 rows (1 c2r / 1 r2c),
     ``dct`` / ``idct`` / ``dst`` type 2 of (131072, 1024) (1 r2c / 1 c2r /
     1 r2c), ``dct`` type 1 of (131072, 1025) (1 r2c at n = 2048) and type 4
     of (16384, 8192) (1 c2c at N = 16384).  Every element against its
     plain version on the card, the first images or rows against float64;
     time beside a same-run ``copy_`` of the input, the bound (bytes in +
     out over the memory rate), ``torch.fft``'s one call where there is one
     (else the same recipe over ``torch.fft``), and, after the counters are
     read, the sum of the path's kernels timed alone on its shapes.  Then
     the column route at the imaging cell's 16384^2 grid
     (``phase_column_route``): each column pass and the row kernel alone
     beside one sweep's floor, ``fft2`` beside ``torch.fft.fft2``; and the
     fused column launch there (``phase_fused_columns``): both directions
     against the two launches bit for bit, its time beside one sweep's
     floor and the two launches', its launches and its waits.
 19. Parallel sweep (``smfft_tpu_torch.parallel``), (a) in a world of one
     rank under NCCL in this process: ``sharded_fft`` forward and inverse,
     ``sharded_rfft`` / ``sharded_irfft``, ``sharded_convolve`` with an
     M_BANK bank at N = 1024 / 16384; ``distributed_fft`` natural and
     transposed, ``distributed_ifft`` and the spectral filter applied in the
     C-layout between a transposed forward and a ``transposed_input``
     inverse at N = 2^15 / 2^20 / 2^24; ``distributed_rfft`` /
     ``distributed_irfft`` at 2^16 / 2^24; both tiers; every element
     against the same call under ``plain_on_card()`` and the first rows
     against float64 ``torch.fft`` within PERF.md §2's bars (a chain of
     k + 1 transforms 2 bound sqrt(k + 1)).  (b) PAR_GLOO gloo ranks
     spawned on this one card (NCCL takes one rank a card): the same
     functions at 2^20 and 2^24, the DTensor round trip and the C-layout
     filter, against float64 and the world of one's plain version; each
     rank's launch counters come back through its results file and are
     summed.
 20. The parallel main path at 2^27 points or samples a call, under (a):
     ``sharded_fft`` of (131072, 1024) (1 c2c), ``sharded_convolve`` with
     a 4-filter bank at N = 1024 (1 conv), ``distributed_fft`` of one 2^27
     vector (2 c2c), ``distributed_rfft`` of 2^28 real samples (2 c2c),
     and ``examples/matched_filter_torch.py``'s correlation of 16384
     streams of 8192 samples against 8 templates (1 conv_real; the bank's
     spectra 1 r2c), then the whole example with ``--selfcheck``.  Each
     checked and timed (median of 5 CUDA-event runs) beside a same-run
     ``copy_`` of its input, the bound and ``torch.fft``'s call or
     composition; after the counters are read, ``api.fft_large`` of the
     same 2^27 vector.  Under (b): ``distributed_fft`` at 2^24 with 4 gloo
     ranks, timed on rank 0 (gloo loopback: not NCCL across cards).
 21. The acceleration plane at the ``fdas.z200.n2e23`` cell's shape:
     ``accel_plane`` of ACCEL_ROWS spectra of 2^22 + 1 bins at zmax 200
     (201 templates of 233 taps, segments of 2048), both tiers, each call
     one ``conv_plane`` launch (the counts reset just before it), every
     element against the plain composition on the same spectrum (the
     framing, the plain bank, crop and power: the op under
     ``plain_on_card()``) within ACCEL_TOL of its rms, "exact" also within
     8 ulp of its max; then the plane form's time beside the plain
     composition's and the bound (the spectrum read and the plane written
     at peak bandwidth).
 22. The harmonic sum at the ``hsum.h32.n2e23`` cell's width:
     ``ops/harmonic.launch_interbin`` then ``launch_harmonic_sum`` (32
     harmonics, counts on) on HSUM_ROWS spectra of 2^22 + 1 bins from
     ``rfft_large``, both tiers, each pair of calls one ``interbin`` and
     one ``harmonic_sum`` launch (the counts reset just before it); the SNR
     against the plain passes on the same spectrum (``interbin_plain``,
     ``stats_plain``, ``sum_plain``) within HSUM_TOL of its rms, which the
     spectrum rounded to bfloat16 must fail.  Then each kernel alone at the
     cell's 128 trials (counts off, as the cell calls it) beside its plain
     pass on the card and its bound (the bytes the launch's tensors hold at
     peak bandwidth, or its operations).
  Before each of the main paths 4, 5, 8, 10, 12, 14, 16, 18, 20, 21 and 22 the
     launch counts are read; right after, their rise must equal the
     path's calls (the convolution path runs ``conv`` / ``conv_real`` and,
     once a ``fftconvolve`` call, the R2C or C2C kernel for the taps; a
     ``sharded_*`` call is one launch of its kernel a rank, a distributed
     C2C two ``c2c`` launches a rank) and no other kernel may have run;
     the gloo ranks' summed counters likewise.

The last lines are the card, a JSON line of kernel results and the device
line.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from h100bench import peaks

SEED = 1234
SWEEP_POINTS = 1 << 22
MAIN_POINTS = 1 << 27
MAIN_SIZES = (1024, 4096, 16384)
ORACLE_ROWS = 64
REPS = 7
# the new phases: the reuse loop's iterations (the reference's NREUSES),
# the bank size, the streams filtered by overlap-save, and repetitions
ITERS = 100
M_BANK = 4
M_SWEEP = 3
STREAMS, STREAM_LEN, TAPS = 64, 1 << 21, 129
REPS_REUSE = 3
REPS_CONV = 5
# the acceleration plane: the fdas.z200.n2e23 cell's trials, samples and
# drift grid, and test_torch_accel.TOL, max |got - plain| / rms(plain)
ACCEL_ROWS, ACCEL_SAMPLES, ACCEL_ZMAX, ACCEL_DZ = 2, 1 << 23, 200, 2
ACCEL_TOL = 5e-5
# the harmonic sum: the hsum.h32.n2e23 cell's samples, harmonics and trials,
# a few trials for the check, and test_torch_periodicity.HTOL, max |got -
# plain| / rms(plain) over the SNR
HSUM_ROWS, HSUM_CELL_ROWS, HSUM_SAMPLES, HSUM_H = 3, 128, 1 << 23, 32
HSUM_TOL = 2e-5
# the spectral phases: power sizes, Welch's frames, and the arbitrary
# lengths with the rows of their main path
POWER_SIZES = (256, 512, 1024, 2048, 4096)
NPERSEG, NOVERLAP = 1024, 512
BLUESTEIN_SIZES = (3, 100, 129, 1000, 1536, 4097, 6000, 8191)
BLUESTEIN_MAIN = {1000: 1 << 17, 4097: 1 << 15}
RESAMPLE_TO = 768
COMPOSITION = "torch.fft.rfft(x*w).abs().square()"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(n: int) -> float:
    """The error bound the TPU kernels met on their chip."""
    return 2e-7 * n ** 0.75 * 8


def ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 23)


def least_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, against the published
    peaks (``h100bench.peaks``), and which of the two bounds it."""
    seconds, by = peaks.least_seconds(nbytes, flops)
    return seconds * 1e3, by


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


_counts_base: dict = {}


def reset_counts() -> None:
    """Take the launch counts (``parallel.dryrun.counts``) as the base of
    :func:`counts`."""
    from smfft_tpu_torch.parallel import dryrun
    _counts_base.update(dryrun.counts())


def counts() -> dict:
    """Every kernel's launches since :func:`reset_counts`."""
    from smfft_tpu_torch.parallel import dryrun
    return {name: n - _counts_base.get(name, 0)
            for name, n in dryrun.counts().items()}


def check_counts(path: str, expected: dict) -> dict:
    """The counters after a main path: ``expected`` names the kernels the
    path runs and their calls; every other kernel must not have run."""
    got = counts()
    want = {name: expected.get(name, 0) for name in got}
    print(f"launch counters over the {path} main path: {got} (expected "
          f"{want})")
    if got != want or not all(got[name] for name in expected):
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


def check_all(y, plain, n: int, what: str, lim: float | None = None,
              against: str = "plain") -> float:
    """Every row of y (a tensor or a planar pair) against the plain
    version's output on the same input (or another reference, named by
    ``against``), within ``lim`` (default bound(n)); returns the max abs
    error."""
    lim = bound(n) if lim is None else lim
    first = y[0] if isinstance(y, tuple) else y
    finite = all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex()
                                     else t).all())
                 for t in (y if isinstance(y, tuple) else (y,)))
    if not finite:
        fail(f"{what}: non-finite output")
    err = max_err(y, plain)
    print(f"  {what}: all {first.shape[-2]} rows vs {against} {err:.3e} "
          f"(bound {lim:.3e})")
    if not err <= lim:
        fail(f"{what}: error {err:.3e} against the {against} over bound")
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


def c2r_alone(card: str) -> float:
    """The C2R kernel alone on the main path's planar spectrum shape (n =
    MAIN_SIZES[0], 2^27 samples): ten launches of ``smfft_c2r`` between two
    events, the tables made once, so that the wrapper's host work drops
    out; the median of REPS, in ms a launch.  The launches go past the
    wrapper and its count."""
    from smfft_tpu_torch.ops import _cuda
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import real as R
    n = MAIN_SIZES[0]
    L, b = n // 2, MAIN_POINTS // n
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    hr = torch.rand((b, L), generator=gen, device="cuda") - 0.5
    hi = torch.rand((b, L), generator=gen, device="cuda") - 0.5
    y = torch.empty((b, n), device="cuda")
    tw = C.device_twiddles(L, True, False, hr.device)
    wn = R.split_table(n, False, hr.device)
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream

    def ten():
        for _ in range(10):
            err = lib.smfft_c2r(hr.data_ptr(), hi.data_ptr(), 0, y.data_ptr(),
                                b, n, 1.0 / L, tw.data_ptr(), wn.data_ptr(),
                                0, stream)
            if err:
                fail(f"smfft_c2r returned CUDA error {err}")

    ms = cuda_ms(ten) / 10
    if not bool(torch.isfinite(y).all()):
        fail("the C2R kernel alone: non-finite output")
    print(f"C2R kernel alone, n={n} batch={b} ({card}): {ms:.4f} ms a "
          "launch")
    del hr, hi, y
    torch.cuda.empty_cache()
    return ms


def reuse_bound(n: int, iters: int) -> float:
    """Error bound of a chain of iters + 1 transforms: each transform is
    unitary up to its 1/sqrt(N) scale, so the rounding errors of the steps
    add like a random walk, about sqrt(iters + 1) times one transform's;
    twice that, over bound(n)."""
    return 2.0 * bound(n) * math.sqrt(iters + 1)


def b1_oracle(x: torch.Tensor, iters: int, ordered: bool) -> torch.Tensor:
    """fft_planar(multiple_iters=iters) in float64 torch.fft: each
    re-application is kernel A's natural -> revblock map times 1/sqrt(N),
    its revblock row read back as natural input."""
    y = x.to(torch.complex128)
    s = 1.0 / math.sqrt(x.shape[-1])
    for _ in range(iters):
        y = to_revblock(torch.fft.fft(y)) * s
    out = torch.fft.fft(y)
    return out if ordered else to_revblock(out)


def phase_reuse_sweep():
    """Both reuse kernels against their plain versions and independent
    oracles at every size: the fft_planar(multiple_iters) form in both
    tiers, ordered and revblock out, k = 1 and 3, against float64
    torch.fft with the revblock map between steps; the pencil form at k = 1
    and 4 ((F / sqrt(N))^4 = I returns x); the real form at iters = 2 and
    4 (returns x).  Returns the max |kernel - plain| of each kernel."""
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import multiple as M
    from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"c2c_multiple": 0.0, "real_multiple": 0.0}
    for n in SUPPORTED_C2C_SIZES:
        row = max(n, 128)
        b = SWEEP_POINTS // n
        x = rand_complex(b, n, gen)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        line = []
        for exact in (False, True):
            for ordered in (True, False):
                for k in (1, 3):
                    o = C.fft_planar(xr.view(-1, row), xi.view(-1, row), n,
                                     ordered=ordered, exact=exact,
                                     multiple_iters=k)
                    got = torch.complex(*o).view(b, n)
                    plain = torch.complex(*M.multiple_plain(
                        xr, xi, loops=k, fb_rev=True, last_rev=True,
                        rev_out=not ordered, exact=exact))
                    torch.cuda.synchronize()
                    e = max_err(got, plain)
                    o64 = max_err(got[:ORACLE_ROWS],
                                  b1_oracle(x[:ORACLE_ROWS], k, ordered))
                    if max(e, o64) > reuse_bound(n, k):
                        fail(f"reuse fft_planar n={n} k={k} exact={exact} "
                             f"ordered={ordered}: {e:.3e} / {o64:.3e} over "
                             f"{reuse_bound(n, k):.3e}")
                    worst["c2c_multiple"] = max(worst["c2c_multiple"], e)
                    line.append(f"{'x' if exact else 'h'}{'o' if ordered else 'r'}"
                                f"{k} {e:.2e}/{o64:.2e}")
        if n <= 4096:
            for k in (1, 4):
                o = M.multiple_pencil_planar(xr, xi, n, k)
                got = torch.complex(*o)
                plain = torch.complex(*M.multiple_plain(
                    xr, xi, loops=k - 1, scale=1.0 / math.sqrt(n)))
                want = x if k == 4 else torch.fft.fft(
                    x[:ORACLE_ROWS].to(torch.complex128)) / math.sqrt(n)
                torch.cuda.synchronize()
                e = max_err(got, plain)
                o64 = max_err(got if k == 4 else got[:ORACLE_ROWS], want)
                if max(e, o64) > reuse_bound(n, k):
                    fail(f"reuse pencil n={n} k={k}: {e:.3e} / {o64:.3e}")
                worst["c2c_multiple"] = max(worst["c2c_multiple"], e)
                line.append(f"pencil{k} {e:.2e}/{o64:.2e}")
        if 256 <= n <= 4096:
            xr_ = torch.rand((b + 3, n), generator=gen, device="cuda") - 0.5
            for iters in (2, 4):
                got = M.multiple_real_pencil_planar(xr_, n, iters)
                plain = M.real_multiple_plain(xr_, iters // 2)
                torch.cuda.synchronize()
                e, ex = max_err(got, plain), max_err(got, xr_)
                if max(e, ex) > reuse_bound(n, iters):
                    fail(f"reuse real n={n} iters={iters}: {e:.3e} / "
                         f"{ex:.3e}")
                worst["real_multiple"] = max(worst["real_multiple"], e)
                line.append(f"real{iters} {e:.2e}/{ex:.2e}")
            del xr_
        print(f"reuse N={n:5d} (vs plain / vs oracle; h/x = highest/exact, "
              f"o/r = ordered/revblock out, k): " + ", ".join(line))
        del x, xr, xi
    print(f"reuse sweep: max |kernel - plain| c2c_multiple "
          f"{worst['c2c_multiple']:.3e}, real_multiple "
          f"{worst['real_multiple']:.3e}")
    return worst


def phase_conv_sweep():
    """Both fused convolution kernels against their plain versions and
    float64 torch.fft at every size, both tiers, single and M_SWEEP
    filters, complex64 and planar (the complex kernel); "exact" within 2
    ulp of max|y|.  Returns the max |kernel - plain| of each kernel."""
    from smfft_tpu_torch.ops import _cuda
    from smfft_tpu_torch.ops import convolve as CV
    from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES
    for line in _cuda.register_report():
        if line.startswith(("conv_kernel", "conv_real_kernel")):
            print(f"  conv ptxas: {line}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = {"conv": 0.0, "conv_real": 0.0}
    worst_ulp = 0.0
    for n in SUPPORTED_C2C_SIZES:
        b = SWEEP_POINTS // n + 3 * max(1, 128 // n)  # ragged
        x = rand_complex(b, n, gen)
        line = []
        for m in (1, M_SWEEP):
            h = rand_complex(m, n, gen)
            want = torch.fft.ifft(
                torch.fft.fft(x[:ORACLE_ROWS].to(torch.complex128))[None]
                * h.to(torch.complex128)[:, None])
            u = ulp(want.abs().max().item())
            for exact in (False, True):
                hd = CV.device_response(h, 1.0 / n, exact, x.device)
                got_c = CV.launch_conv(x, h=hd, exact=exact)
                gr, gi = CV.launch_conv(x.real.contiguous(),
                                        x.imag.contiguous(), h=hd,
                                        exact=exact)
                plain = torch.complex(*CV.conv_plain(
                    x.real, x.imag, (h / n).real, (h / n).imag, exact))
                torch.cuda.synchronize()
                e = o64 = 0.0
                for got in (got_c, torch.complex(gr, gi)):
                    e = max(e, max_err(got, plain))
                    o64 = max(o64, max_err(got[:, :ORACLE_ROWS], want))
                del got_c, gr, gi, plain
                if max(e, o64) > bound(n):
                    fail(f"conv N={n} m={m} exact={exact}: {e:.3e} / "
                         f"{o64:.3e} over {bound(n):.3e}")
                if exact and o64 > 2 * u:
                    fail(f"conv N={n} m={m}: 'exact' is {o64 / u:.2f} ulp "
                         "from float64, over its contract of 2")
                worst["conv"] = max(worst["conv"], e)
                if exact:
                    worst_ulp = max(worst_ulp, o64 / u)
                line.append(f"m={m} {'exact' if exact else 'highest'} "
                            f"{e:.2e}/{o64:.2e} ({o64 / u:.2f} ulp)")
        print(f"conv N={n:5d} (vs plain / vs float64): " + ", ".join(line))
        del x
        if n < 256:
            continue
        L = n // 2
        xr = torch.rand((SWEEP_POINTS // n + 3, n), generator=gen,
                        device="cuda") - 0.5
        line = []
        for m in (1, M_SWEEP):
            h = torch.fft.rfft(torch.rand((m, n), generator=gen,
                                          device="cuda") - 0.5).to(
                                              torch.complex64)
            want = torch.fft.irfft(
                torch.fft.rfft(xr[:ORACLE_ROWS].double())[None]
                * h.to(torch.complex128)[:, None], n)
            u = ulp(want.abs().max().item())
            pk = CV.pack_real_response(h) / L
            for exact in (False, True):
                got = CV.launch_conv_real(
                    xr, h=CV.device_response(CV.pack_real_response(h),
                                             1.0 / L, exact, xr.device),
                    exact=exact)
                plain = CV.conv_real_plain(xr, pk.real, pk.imag, exact)
                torch.cuda.synchronize()
                e = max_err(got, plain)
                o64 = max_err(got[:, :ORACLE_ROWS], want)
                del got, plain
                if max(e, o64) > bound(n):
                    fail(f"conv_real n={n} m={m} exact={exact}: {e:.3e} / "
                         f"{o64:.3e} over {bound(n):.3e}")
                if exact and o64 > 2 * u:
                    fail(f"conv_real n={n} m={m}: 'exact' is "
                         f"{o64 / u:.2f} ulp from float64")
                worst["conv_real"] = max(worst["conv_real"], e)
                if exact:
                    worst_ulp = max(worst_ulp, o64 / u)
                line.append(f"m={m} {'exact' if exact else 'highest'} "
                            f"{e:.2e}/{o64:.2e} ({o64 / u:.2f} ulp)")
        print(f"conv_real n={n:5d} (vs plain / vs float64): "
              + ", ".join(line))
        del xr
    print(f"convolution sweep: max |kernel - plain| conv {worst['conv']:.3e}"
          f", conv_real {worst['conv_real']:.3e}; 'exact' at most "
          f"{worst_ulp:.2f} ulp(max|y|)")
    return worst


def phase_main_reuse(card: str):
    """The reuse main path at 2^27 points (samples) per call, ITERS
    transforms held on chip: fft_planar(multiple_iters=ITERS) at N = 1024 /
    4096 / 16384, multiple_pencil_planar(iters=ITERS) and
    multiple_real_pencil_planar(iters=ITERS) at N = 1024 / 4096.  Every
    row against the plain version (and the pencil and real forms, whose
    ITERS = 100 is a multiple of 4, against x itself); the first rows of
    the fft_planar form against float64 torch.fft.  Returns (rows, calls
    per kernel, worst error per kernel)."""
    from smfft_tpu_torch.ops import _cuda
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import multiple as M
    for line in _cuda.register_report():
        if line.startswith(("c2c_multiple_kernel", "real_multiple_kernel")):
            print(f"  reuse ptxas: {line}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows, calls = [], {"c2c_multiple": 0, "real_multiple": 0}
    worst = {"c2c_multiple": 0.0, "real_multiple": 0.0}
    lim = {n: reuse_bound(n, ITERS) for n in MAIN_SIZES}

    def margin(form: str, n: int, err: float, against: str) -> float:
        """The chained bound over the error after the loop's transforms."""
        k = ITERS + 1 if form == "fft_planar" else ITERS
        print(f"  {form} N={n}: error after {k} transforms {err:.3e} "
              f"against {against}, bound "
              f"2*bound(N)*sqrt({ITERS}+1) = {lim[n]:.3e}, margin "
              f"{lim[n] / err:.1f}x")
        return lim[n] / err
    for n in MAIN_SIZES:
        b = MAIN_POINTS // n
        x = rand_complex(b, n, gen)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        del x
        o = C.fft_planar(xr, xi, n, ordered=True, multiple_iters=ITERS)
        calls["c2c_multiple"] += 1
        plain = M.multiple_plain(xr, xi, loops=ITERS, fb_rev=True,
                                 last_rev=True)
        worst["c2c_multiple"] = max(worst["c2c_multiple"], check_all(
            o, plain, n, f"fft_planar(multiple_iters={ITERS}) N={n}",
            lim[n]))
        del plain
        head = torch.complex(xr[:ORACLE_ROWS], xi[:ORACLE_ROWS])
        e64 = max_err(torch.complex(*o)[:ORACLE_ROWS],
                      b1_oracle(head, ITERS, True))
        print(f"  first {ORACLE_ROWS} rows vs float64 torch.fft with the "
              f"revblock map: {e64:.3e}")
        if e64 > lim[n]:
            fail(f"reuse N={n}: {e64:.3e} against float64 over bound")
        m64 = margin("fft_planar", n, e64, "float64 torch.fft")
        del o
        ms = cuda_ms(lambda: C.fft_planar(xr, xi, n, ordered=True,
                                          multiple_iters=ITERS),
                     reps=REPS_REUSE)
        calls["c2c_multiple"] += 1 + REPS_REUSE
        ms_plain = cuda_ms(lambda: M.multiple_plain(
            xr, xi, loops=ITERS, fb_rev=True, last_rev=True), reps=1)
        rows.append({"form": "fft_planar", "n": n, "batch": b, "ms": ms,
                     "plain_ms": ms_plain, "transforms": ITERS + 1,
                     "err_margin": m64})
        if n <= 4096:
            o = M.multiple_pencil_planar(xr, xi, n, ITERS)
            calls["c2c_multiple"] += 1
            plain = M.multiple_plain(xr, xi, loops=ITERS - 1,
                                     scale=1.0 / math.sqrt(n))
            worst["c2c_multiple"] = max(worst["c2c_multiple"], check_all(
                o, plain, n, f"multiple_pencil_planar(iters={ITERS}) N={n}",
                lim[n]))
            del plain
            mp = margin("pencil", n, check_all(
                o, (xr, xi), n, f"multiple_pencil_planar(iters={ITERS}) "
                f"N={n}", lim[n], against="x ((F/sqrt N)^4 = I)"), "x")
            del o
            ms = cuda_ms(lambda: M.multiple_pencil_planar(xr, xi, n, ITERS),
                         reps=REPS_REUSE)
            calls["c2c_multiple"] += 1 + REPS_REUSE
            ms_plain = cuda_ms(lambda: M.multiple_plain(
                xr, xi, loops=ITERS - 1, scale=1.0 / math.sqrt(n)), reps=1)
            rows.append({"form": "pencil", "n": n, "batch": b, "ms": ms,
                         "plain_ms": ms_plain, "transforms": ITERS,
                         "err_margin": mp})
            y = M.multiple_real_pencil_planar(xr, n, ITERS)
            calls["real_multiple"] += 1
            plain = M.real_multiple_plain(xr, ITERS // 2)
            worst["real_multiple"] = max(worst["real_multiple"], check_all(
                y, plain, n, f"multiple_real_pencil_planar(iters={ITERS}) "
                f"n={n}", lim[n]))
            del plain
            mr = margin("real", n, check_all(
                y, xr, n, f"multiple_real_pencil_planar(iters={ITERS}) "
                f"n={n}", lim[n], against="x"), "x")
            del y
            ms = cuda_ms(lambda: M.multiple_real_pencil_planar(xr, n, ITERS),
                         reps=REPS_REUSE)
            calls["real_multiple"] += 1 + REPS_REUSE
            ms_plain = cuda_ms(lambda: M.real_multiple_plain(
                xr, ITERS // 2), reps=1)
            rows.append({"form": "real", "n": n, "batch": b, "ms": ms,
                         "plain_ms": ms_plain, "transforms": ITERS,
                         "err_margin": mr})
        del xr, xi
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


def reuse_references(rows: list, card: str) -> None:
    """After the reuse path's counters are read: each form's single-call
    time (planar.fft; planar.rfft + planar.irfft for a real pair) on the
    same shapes, the bound (operations at the fp32 peak), MFFT/s and the
    ratio of ITERS single calls to one reuse call."""
    import smfft_tpu_torch as T
    for r in rows:
        n, b = r["n"], r["batch"]
        if r["form"] == "real":
            x = torch.rand((b, n), device="cuda") - 0.5
            hr, hi = T.planar.rfft(x)
            single = (cuda_ms(lambda: T.planar.rfft(x))
                      + cuda_ms(lambda: T.planar.irfft(hr, hi))) / 2
            del x, hr, hi
            flops = r["transforms"] * b * (2.5 * n * math.log2(n) + 5 * n)
            nbytes = 8.0 * b * n
        else:
            xr = torch.rand((b, n), device="cuda")
            xi = torch.rand((b, n), device="cuda")
            single = cuda_ms(lambda: T.planar.fft(xr, xi))
            del xr, xi
            flops = r["transforms"] * b * 5.0 * n * math.log2(n)
            nbytes = 16.0 * b * n
        torch.cuda.empty_cache()
        r["bound_ms"], r["bound_by"] = least_ms(nbytes, flops)
        r["single_ms"] = single
        r["mfft_s"] = b * ITERS / r["ms"] / 1e3
        r["ratio_to_single_calls"] = ITERS * single / r["ms"]
        print(f"reuse {r['form']:10s} N={n:5d} batch={b} iters={ITERS} "
              f"({card}): {r['ms']:.4f} ms = {r['mfft_s']:.1f} MFFT/s "
              f"(rows x iters / time) | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), at {r['bound_ms'] / r['ms']:.3f} | "
              f"{ITERS} single calls {ITERS * single:.4f} ms, "
              f"{r['ratio_to_single_calls']:.2f}x | plain "
              f"{r['plain_ms']:.1f} ms")


def overlap_save(x: torch.Tensor, taps: torch.Tensor,
                 library: bool = False) -> torch.Tensor:
    """signal.fftconvolve's overlap-save ("full" mode) with the fused
    kernel's plain version in its place (the check of every output row),
    or with the torch.fft three-call composition (``library``, a
    yardstick)."""
    from smfft_tpu_torch import signal as S
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import convolve as CV
    from smfft_tpu_torch.ops import real as R
    b, t = x.shape
    k = taps.shape[-1]
    n = S._pick_nfft(k)
    hop, full = n - k + 1, t + k - 1
    frames = -(-full // hop)
    real = not x.is_complex()
    pad = torch.zeros((b, (frames - 1) * hop + n - (k - 1) - t),
                      dtype=x.dtype, device=x.device)
    xp = torch.cat([torch.zeros((b, k - 1), dtype=x.dtype, device=x.device),
                    x, pad], dim=-1)
    fx = xp.unfold(-1, n, hop).reshape(b * frames, n)
    pt = S._pad_taps(taps, n, real)
    if library and real:
        y = torch.fft.irfft(torch.fft.rfft(fx) * torch.fft.rfft(pt), n)
    elif library:
        y = torch.fft.ifft(torch.fft.fft(fx) * torch.fft.fft(pt))
    elif real:
        hf = R.to_layout(*R.r2c_plain(pt), "numpy")
        pk = CV.pack_real_response(hf) / (n // 2)
        y = CV.conv_real_plain(fx, pk.real, pk.imag)[0]
    else:
        hf = torch.complex(*C.c2c_plain(pt.real, pt.imag)) / n
        y = torch.complex(*CV.conv_plain(fx.real, fx.imag, hf.real,
                                         hf.imag))[0]
    return y.reshape(b, frames, n)[:, :, k - 1:].reshape(
        b, frames * hop)[:, :full]


def linear_oracle(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The full linear convolution of each row in float64 torch.fft."""
    full = x.shape[-1] + taps.shape[-1] - 1
    m = 1 << (full - 1).bit_length()
    if x.is_complex():
        y = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128), m)
                           * torch.fft.fft(taps.to(torch.complex128), m))
    else:
        y = torch.fft.irfft(torch.fft.rfft(x.double(), m)
                            * torch.fft.rfft(taps.double(), m), m)
    return y[..., :full]


def phase_main_conv(card: str):
    """The convolution main path at 2^27 points or samples per call:
    convolve at N = 1024 / 4096 / 16384 and an M_BANK bank at 1024,
    planar.convolve at 1024, convolve_real at n = 1024 / 4096 / 16384 and
    an M_BANK bank at 1024, and fftconvolve of STREAMS real streams of
    STREAM_LEN samples with TAPS taps and of complex streams of the same
    shape.  Every row of every output against the plain version, the first
    rows against float64 torch.fft (every stream for fftconvolve).  Returns
    (rows, calls per kernel, worst error per kernel)."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import convolve as CV
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    calls = {"conv": 0, "conv_real": 0, "r2c": 0, "c2c": 0}
    worst = {"conv": 0.0, "conv_real": 0.0}

    def record(name, kind, n, b, m, fn, plain_fn, comp_fn, nbytes, flops,
               x_like):
        ms = cuda_ms(fn, reps=REPS_CONV)
        calls[kind] += 1 + REPS_CONV
        dst = torch.empty_like(x_like)
        ms_copy = cuda_ms(lambda: dst.copy_(x_like), reps=REPS_CONV)
        copy_gbs = 2.0 * dst.numel() * dst.element_size() / ms_copy / 1e6
        del dst
        ms_plain = cuda_ms(plain_fn, reps=1)
        ms_comp = cuda_ms(comp_fn, reps=REPS_CONV)
        torch.cuda.empty_cache()
        bound_ms, bound_by = least_ms(nbytes, flops)
        gb = nbytes / 1e9
        row = {"what": name, "n": n, "batch": b, "m": m, "ms": ms,
               "gbs": gb / ms * 1e3, "copy_ms": ms_copy,
               "copy_gbs": copy_gbs, "plain_ms": ms_plain,
               "composition_ms": ms_comp, "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        print(f"{name} N={n:5d} batch={b} m={m} ({card}): {ms:.4f} ms = "
              f"{gb / ms * 1e3:.1f} GB/s | copy_ of the input {ms_copy:.4f} "
              f"ms = {copy_gbs:.1f} GB/s | bound {bound_ms:.4f} ms "
              f"({bound_by}), at "
              f"{bound_ms / ms:.3f} | plain {ms_plain:.2f} ms | torch.fft "
              f"composition (3 calls) {ms_comp:.4f} ms")

    for n in MAIN_SIZES:
        b = MAIN_POINTS // n
        lg = math.log2(n)
        x = rand_complex(b, n, gen)
        for m in ((1, M_BANK) if n == 1024 else (1,)):
            h = rand_complex(m, n, gen)
            hh = h if m > 1 else h[0]
            plain = torch.complex(*CV.conv_plain(x.real, x.imag,
                                                 (h / n).real,
                                                 (h / n).imag))
            y = T.convolve(x, hh)
            calls["conv"] += 1
            if m == 1:
                plain = plain[0]
            what = f"convolve{' bank' if m > 1 else ''}"
            worst["conv"] = max(worst["conv"], check_all(
                y, plain, n, f"{what} N={n} m={m}"))
            del plain
            head = torch.fft.fft(x[:ORACLE_ROWS].to(torch.complex128))
            want = torch.fft.ifft(head[None] * h.to(torch.complex128)[:, None])
            e64 = max_err(y.reshape(m, b, n)[:, :ORACLE_ROWS], want)
            print(f"  first {ORACLE_ROWS} rows vs float64 torch.fft: {e64:.3e}")
            if e64 > bound(n):
                fail(f"{what} N={n}: {e64:.3e} against float64 over bound")
            del y
            record(what, "conv", n, b, m, lambda: T.convolve(x, hh),
                   lambda: CV.conv_plain(x.real, x.imag, (h / n).real,
                                         (h / n).imag),
                   lambda: torch.fft.ifft(torch.fft.fft(x)[None]
                                          * h[:, None]),
                   (8.0 + 8.0 * m) * MAIN_POINTS,
                   MAIN_POINTS * (5.0 * lg * (1 + m) + 6.0 * m), x)
            if n == 1024 and m == 1:
                xr, xi = x.real.contiguous(), x.imag.contiguous()
                o = T.planar.convolve(xr, xi, hh.real, hh.imag)
                calls["conv"] += 1
                plain = CV.conv_plain(xr, xi, (h / n).real, (h / n).imag)
                worst["conv"] = max(worst["conv"], check_all(
                    o, (plain[0][0], plain[1][0]), n,
                    f"planar.convolve N={n}"))
                del o, plain
                record("planar.convolve", "conv", n, b, 1,
                       lambda: T.planar.convolve(xr, xi, hh.real, hh.imag),
                       lambda: CV.conv_plain(xr, xi, (h / n).real,
                                             (h / n).imag),
                       lambda: torch.fft.ifft(torch.fft.fft(x) * hh),
                       16.0 * MAIN_POINTS,
                       MAIN_POINTS * (10.0 * lg + 6.0), x)
                del xr, xi
        del x
        torch.cuda.empty_cache()

        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        L = n // 2
        for m in ((1, M_BANK) if n == 1024 else (1,)):
            h = torch.fft.rfft(torch.rand((m, n), generator=gen,
                                          device="cuda") - 0.5).to(
                                              torch.complex64)
            hh = h if m > 1 else h[0]
            pk = CV.pack_real_response(h) / L
            plain = CV.conv_real_plain(x, pk.real, pk.imag)
            y = T.convolve_real(x, hh)
            calls["conv_real"] += 1
            if m == 1:
                plain = plain[0]
            what = f"convolve_real{' bank' if m > 1 else ''}"
            worst["conv_real"] = max(worst["conv_real"], check_all(
                y, plain, n, f"{what} n={n} m={m}"))
            del plain
            want = torch.fft.irfft(
                torch.fft.rfft(x[:ORACLE_ROWS].double())[None]
                * h.to(torch.complex128)[:, None], n)
            e64 = max_err(y.reshape(m, b, n)[:, :ORACLE_ROWS], want)
            print(f"  first {ORACLE_ROWS} rows vs float64 torch.fft: {e64:.3e}")
            if e64 > bound(n):
                fail(f"{what} n={n}: {e64:.3e} against float64 over bound")
            del y
            record(what, "conv_real", n, b, m,
                   lambda: T.convolve_real(x, hh),
                   lambda: CV.conv_real_plain(x, pk.real, pk.imag),
                   lambda: torch.fft.irfft(torch.fft.rfft(x)[None]
                                           * h[:, None], n),
                   (4.0 + 4.0 * m) * MAIN_POINTS,
                   MAIN_POINTS * ((2.5 * math.log2(n) + 5.0) * (1 + m)
                                  + 3.0 * m), x)
        del x
        torch.cuda.empty_cache()

    # overlap-save FIR filtering of sampled streams
    from smfft_tpu_torch import signal as S
    samples = STREAMS * STREAM_LEN
    for cplx in (False, True):
        if cplx:
            x = rand_complex(STREAMS, STREAM_LEN, gen)
            taps = rand_complex(1, TAPS, gen)[0]
        else:
            x = torch.rand((STREAMS, STREAM_LEN), generator=gen,
                           device="cuda") - 0.5
            taps = torch.rand(TAPS, generator=gen, device="cuda") - 0.5
        y = T.fftconvolve(x, taps)
        calls["conv" if cplx else "conv_real"] += 1
        calls["c2c" if cplx else "r2c"] += 1
        n_fft = S._pick_nfft(TAPS)
        what = f"fftconvolve {'complex' if cplx else 'real'}"
        kernel = "conv" if cplx else "conv_real"
        worst[kernel] = max(worst[kernel], check_all(
            y, overlap_save(x, taps), n_fft, f"{what} K={TAPS}"))
        check_all(y, linear_oracle(x, taps), n_fft, f"{what} K={TAPS}",
                  bound(n_fft) * math.sqrt(TAPS), against="float64 torch.fft")
        del y
        ms = cuda_ms(lambda: T.fftconvolve(x, taps), reps=REPS_CONV)
        calls[kernel] += 1 + REPS_CONV
        calls["c2c" if cplx else "r2c"] += 1 + REPS_CONV
        per = 16.0 if cplx else 8.0
        hop = n_fft - TAPS + 1
        frames = -(-(STREAM_LEN + TAPS - 1) // hop) * STREAMS
        lg = math.log2(n_fft)
        flops = frames * n_fft * ((10.0 * lg + 6.0) if cplx else
                                  (5.0 * lg + 13.0))
        bound_ms, bound_by = least_ms(per * samples, flops)
        dst = torch.empty_like(x)
        ms_copy = cuda_ms(lambda: dst.copy_(x), reps=REPS_CONV)
        del dst
        ms_plain = cuda_ms(lambda: overlap_save(x, taps), reps=1)
        ms_comp = cuda_ms(lambda: overlap_save(x, taps, library=True),
                          reps=REPS_CONV)
        torch.cuda.empty_cache()
        print(f"{what} {STREAMS} x {STREAM_LEN} samples, K={TAPS}, n_fft="
              f"{n_fft} ({card}): {ms:.4f} ms = {samples / ms / 1e6:.2f} "
              f"Gsamples/s = {per * samples / ms / 1e6:.1f} GB/s | copy_ of "
              f"the input {ms_copy:.4f} ms | bound {bound_ms:.4f} ms "
              f"({bound_by}; {per:.0f} B a sample in+out), at "
              f"{bound_ms / ms:.3f} | plain {ms_plain:.2f} ms | the same "
              f"framing around the torch.fft composition {ms_comp:.4f} ms")
        rows.append({"what": what, "n": n_fft, "batch": STREAMS,
                     "m": 1, "ms": ms, "gbs": per * samples / ms / 1e6,
                     "copy_ms": ms_copy, "plain_ms": ms_plain,
                     "composition_ms": ms_comp, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del x
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst

def time_path(what: str, card: str, fn, plain_fn, ref_fn, ref_name: str,
              x_like: torch.Tensor, nbytes: float, flops: float,
              counted_bytes: float | None = None) -> dict:
    """A main path's row: fn's median CUDA-event time over REPS_CONV runs,
    a same-run copy_ of x_like, the plain version (one run) and a PyTorch
    reference on the same inputs, and the bound (nbytes moved once, flops
    at the fp32 peak).  GB/s counts counted_bytes (default nbytes)."""
    ms = cuda_ms(fn, reps=REPS_CONV)
    dst = torch.empty_like(x_like)
    ms_copy = cuda_ms(lambda: dst.copy_(x_like), reps=REPS_CONV)
    del dst
    ms_plain = cuda_ms(plain_fn, reps=1)
    ms_ref = cuda_ms(ref_fn, reps=REPS_CONV)
    torch.cuda.empty_cache()
    bound_ms, bound_by = least_ms(nbytes, flops)
    gbs = (nbytes if counted_bytes is None else counted_bytes) / ms / 1e6
    print(f"{what} ({card}): {ms:.4f} ms = {gbs:.1f} GB/s | copy_ of the "
          f"input {ms_copy:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}), "
          f"at {bound_ms / ms:.3f} | plain {ms_plain:.2f} ms | {ref_name} "
          f"{ms_ref:.4f} ms")
    return {"what": what, "ms": ms, "gbs": gbs, "copy_ms": ms_copy,
            "plain_ms": ms_plain, "reference": ref_name,
            "reference_ms": ms_ref, "bound_ms": bound_ms,
            "bound_by": bound_by}


def power_bound(n: int, x_max: float) -> float:
    """Error bound of a power bin |X|^2 whose X is within bound(n):
    2 bound(n) max|X| + bound(n)^2."""
    return 2.0 * bound(n) * x_max + bound(n) ** 2


def power_composition(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The power spectrum as PyTorch calls: rfft, abs, square, slice."""
    return torch.fft.rfft(x * w).abs().square()[..., :x.shape[-1] // 2]


def power_oracle(x: torch.Tensor, window) -> tuple[torch.Tensor, float]:
    """float64 one-sided power of x's rows (slot 0 = DC^2, no Nyquist) and
    max|X|."""
    xw = x.double() if window is None else x.double() * window.double()
    spec = torch.fft.rfft(xw)
    pw = spec.abs().square()[..., :x.shape[-1] // 2]
    pw[..., 0] = spec[..., 0].real.square()
    return pw, spec.abs().max().item()


def phase_spectral_sweep():
    """power_kernel at every n with and without a hann window against
    power_plain (every row) and float64 (the first rows); the stft -> istft
    round trip, hilbert and welch on small inputs against float64.
    Returns the max |kernel - plain|."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch import signal as S
    from smfft_tpu_torch.ops import spectral as SP
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst = 0.0
    for n in POWER_SIZES:
        x = torch.rand((SWEEP_POINTS // n + 3, n), generator=gen,
                       device="cuda") - 0.5
        line = []
        for window in (None, T.get_window("hann", n).cuda()):
            got = SP.launch_power(x, window)
            plain = SP.power_plain(x, window)
            want, x_max = power_oracle(x[:ORACLE_ROWS], window)
            torch.cuda.synchronize()
            lim = power_bound(n, max(x_max, plain.max().sqrt().item()))
            e, e64 = max_err(got, plain), max_err(got[:ORACLE_ROWS], want)
            if got.shape != plain.shape or max(e, e64) > lim:
                fail(f"power n={n} window={window is not None}: {e:.3e} / "
                     f"{e64:.3e} over {lim:.3e}")
            worst = max(worst, e)
            line.append(f"{'hann' if window is not None else 'none'} "
                        f"{e:.2e}/{e64:.2e} (bound {lim:.2e})")
            del got, plain, want
        print(f"power n={n:5d} (vs plain / vs float64): " + ", ".join(line))
        del x
    # the signal layer on small inputs, against float64
    x = torch.rand((8, 1 << 14), generator=gen, device="cuda") - 0.5
    n_fft, hop = NPERSEG, NPERSEG // 4
    w64 = T.get_window("hann", n_fft).double().cuda()
    z = T.stft(x, n_fft=n_fft, hop_length=hop)
    e_stft = max_err(z, torch.fft.rfft(x.double().unfold(-1, n_fft, hop)
                                       * w64))
    y = T.istft(z, n_fft=n_fft, hop_length=hop, length=x.shape[-1])
    e_rt = (y - x)[:, n_fft:-n_fft].abs().max().item()
    a = T.hilbert(x[:, :4096])
    mask = torch.zeros(4096, dtype=torch.float64, device="cuda")
    mask[0] = mask[2048] = 1.0
    mask[1:2048] = 2.0
    e_h = max_err(a, torch.fft.ifft(torch.fft.fft(x[:, :4096].double())
                                    * mask))
    _, p = T.welch(x, nperseg=n_fft, noverlap=NOVERLAP)
    fx = x.double().unfold(-1, n_fft, n_fft - NOVERLAP)
    spec = torch.fft.rfft((fx - fx.mean(dim=-1, keepdim=True)) * w64)
    base, double = S._spectral_scale(w64, 1.0, "density")
    want = spec.abs().square()[..., :n_fft // 2].mean(dim=-2) * (2 * base)
    want[..., 0] /= 2
    e_w = max_err(p, want) / want.abs().max().item()
    torch.cuda.synchronize()
    print(f"signal layer (float64 references): stft {e_stft:.3e}, stft -> "
          f"istft round trip {e_rt:.3e} (bound {bound(n_fft):.3e}), hilbert "
          f"{e_h:.3e} (bound {bound(4096):.3e}), welch {e_w:.3e} of its "
          "largest bin (limit 1e-5)")
    if max(e_stft, e_rt) > bound(n_fft) or e_h > bound(4096) or e_w > 1e-5:
        fail("the signal layer is over its bound against float64")
    return worst


def phase_main_spectral(card: str):
    """The spectral main path: power_spectrum (hann) at n = 1024 / 4096 with
    2^27 samples, welch and spectrogram of STREAMS x STREAM_LEN samples.
    Every row against the plain version, the first rows (the first
    stream) against float64.  Returns (rows, calls, worst error against
    the plain version)."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch import signal as S
    from smfft_tpu_torch.ops import spectral as SP
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    calls = 0
    worst = 0.0

    def flops(rows_, n):
        return rows_ * n * (2.5 * math.log2(n) + 8.0)

    for n in (1024, 4096):
        b = MAIN_POINTS // n
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        w = T.get_window("hann", n).cuda()
        y = T.power_spectrum(x, window=w)
        calls += 1
        plain = SP.power_plain(x, w)
        want, x_max = power_oracle(x[:ORACLE_ROWS], w)
        lim = power_bound(n, max(x_max, plain.max().sqrt().item()))
        worst = max(worst, check_all(y, plain, n, f"power_spectrum n={n}",
                                     lim))
        check_all(y[:ORACLE_ROWS], want, n, f"power_spectrum n={n}", lim,
                  against="float64 torch.fft")
        del y, plain, want
        rows.append(time_path(
            f"power_spectrum n={n} ({MAIN_POINTS} samples, GB/s at 6 B)",
            card, lambda: T.power_spectrum(x, window=w),
            lambda: SP.power_plain(x, w), lambda: power_composition(x, w),
            COMPOSITION, x,
            6.0 * MAIN_POINTS, flops(b, n)))
        calls += 1 + REPS_CONV
        del x
        torch.cuda.empty_cache()

    # Welch and the spectrogram of sampled streams, and the same framing
    # and scaling around the plain version and the torch.fft composition
    n, hop = NPERSEG, NPERSEG - NOVERLAP
    x = torch.rand((STREAMS, STREAM_LEN), generator=gen, device="cuda") - 0.5
    w = T.get_window("hann", n).cuda()
    base, double = S._spectral_scale(w, 1.0, "density")

    def framed_power(power):
        fx = S._detrend(S._frame(x, n, hop), "constant")
        return power(fx.reshape(-1, n)).reshape(fx.shape[:-1] + (n // 2,))

    plain_pw = lambda r: SP.power_plain(r, w)  # noqa: E731
    frames = 1 + (STREAM_LEN - n) // hop
    samples = STREAMS * frames * n
    pw = framed_power(plain_pw)
    lim = power_bound(n, pw.max().sqrt().item()) * double
    # the first stream in float64
    fx = x[0].double().unfold(-1, n, hop)
    want_pw = power_oracle(fx - fx.mean(dim=-1, keepdim=True), w)[0]
    for what in ("welch", "spectrogram"):
        if what == "welch":
            _, y = T.welch(x, nperseg=n, noverlap=NOVERLAP)
            plain = S._scale_onesided(pw.mean(dim=-2), base, double)
            want = S._scale_onesided(want_pw.mean(dim=-2), base, double)
            out_bytes = 4.0 * STREAMS * (n // 2)
        else:
            _, _, y = T.spectrogram(x, nperseg=n, noverlap=NOVERLAP)
            plain = S._scale_onesided(pw, base, double)
            want = S._scale_onesided(want_pw, base, double)
            out_bytes = 4.0 * samples / 2
        calls += 1
        worst = max(worst, check_all(y, plain, n, f"{what} {STREAMS} x "
                                     f"{STREAM_LEN}", lim))
        check_all(y[:1], want[None], n, f"{what} stream 0", lim,
                  against="float64 torch.fft")
        del y, plain
        fn = ((lambda: T.welch(x, nperseg=n, noverlap=NOVERLAP))
              if what == "welch" else
              (lambda: T.spectrogram(x, nperseg=n, noverlap=NOVERLAP)))

        def with_power(power, what=what):
            p = framed_power(power)
            if what == "welch":
                p = p.mean(dim=-2)
            return S._scale_onesided(p, base, double)
        rows.append(time_path(
            f"{what} {STREAMS} x {STREAM_LEN}, nperseg {n} ({samples} "
            "samples through the kernel, GB/s at 6 B of them)", card, fn,
            lambda: with_power(plain_pw),
            lambda: with_power(lambda r: power_composition(r, w)),
            f"the same framing around {COMPOSITION}", x,
            4.0 * STREAMS * STREAM_LEN + out_bytes,
            flops(STREAMS * frames, n), counted_bytes=6.0 * samples))
        calls += 1 + REPS_CONV
    del x, pw
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


def phase_bluestein_sweep():
    """fft_any, ifft_any and planar.fft_any at every BLUESTEIN_SIZES n and
    both tiers against bluestein_plain (every row) and float64 torch.fft
    (the first rows), within bound(m); "exact" within 2 ulp of max|X|; the
    pad lanes of planar.fft_any exactly 0.  Returns the max |kernel -
    plain| and the worst "exact" ulp."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.bluestein import _conv_length
    from smfft_tpu_torch.ops import chirp as CH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    worst, worst_ulp = 0.0, 0.0
    for n in BLUESTEIN_SIZES:
        m = _conv_length(2 * n - 1)
        b = SWEEP_POINTS // n + 3
        x = rand_complex(b, n, gen)
        head = x[:ORACLE_ROWS].to(torch.complex128)
        wants = (torch.fft.fft(head), torch.fft.ifft(head))
        np_ = CH.n_pad(n)
        vr = torch.zeros((b, np_), device="cuda")
        vi = torch.zeros_like(vr)
        vr[:, :n], vi[:, :n] = x.real, x.imag
        line = []
        for exact in (False, True):
            prec = "exact" if exact else "highest"
            y = T.fft_any(x, precision=prec)
            yi = T.ifft_any(x, precision=prec)
            o_r, o_i = T.planar.fft_any(vr, vi, n=n, precision=prec)
            pf = torch.complex(*CH.bluestein_plain(x.real, x.imag, n, m,
                                                   exact=exact))
            pi = torch.complex(*CH.bluestein_plain(
                x.real, x.imag, n, m, inverse=True, scale=1.0 / n,
                exact=exact))
            torch.cuda.synchronize()
            yp = torch.complex(o_r[:, :n], o_i[:, :n])
            e = max(max_err(y, pf), max_err(yp, pf), max_err(yi, pi))
            e64, u = 0.0, 0.0
            for got, want in ((y, wants[0]), (yp, wants[0]),
                              (yi, wants[1])):
                err = max_err(got[:ORACLE_ROWS], want)
                e64 = max(e64, err)
                u = max(u, err / ulp(want.abs().max().item()))
            pad = max(o_r[:, n:].abs().max().item(),
                      o_i[:, n:].abs().max().item()) if np_ > n else 0.0
            if max(e, e64) > bound(m) or pad != 0.0:
                fail(f"bluestein n={n} {prec}: {e:.3e} / {e64:.3e} over "
                     f"{bound(m):.3e}, pad lanes {pad}")
            if exact and u > 2:
                fail(f"bluestein n={n}: 'exact' is {u:.2f} ulp(max|X|) from "
                     "float64, over its contract of 2")
            worst = max(worst, e)
            if exact:
                worst_ulp = max(worst_ulp, u)
            line.append(f"{prec} {e:.2e}/{e64:.2e} ({u:.2f} ulp)")
            del y, yi, o_r, o_i, pf, pi, yp
        print(f"bluestein n={n:5d} m={m:5d} (fft_any, ifft_any, planar."
              f"fft_any; vs plain / vs float64; pad lanes 0; bound "
              f"{bound(m):.2e}): " + ", ".join(line))
        del x, vr, vi
        torch.cuda.empty_cache()
    print(f"bluestein sweep: max |kernel - plain| {worst:.3e}; 'exact' at "
          f"most {worst_ulp:.2f} ulp(max|X|)")
    return worst, worst_ulp


def resample_ref(x: torch.Tensor, num: int, fft, ifft) -> torch.Tensor:
    """scipy.signal.resample's two-sided path along the last axis, with the
    transforms given (the real part for real x): an independent reference
    for signal.resample."""
    n = x.shape[-1]
    X = fft(x)
    N = min(n, num)
    nyq = N // 2 + 1
    Y = torch.zeros(X.shape[:-1] + (num,), dtype=X.dtype, device=X.device)
    Y[..., :nyq] = X[..., :nyq]
    if N > 2:
        Y[..., nyq - N:] = X[..., nyq - N:]
    if N % 2 == 0 and num < n:
        Y[..., -N // 2] += X[..., -N // 2]
    elif N % 2 == 0 and n < num:
        Y[..., N // 2] *= 0.5
        Y[..., num - N // 2] = Y[..., N // 2]
    y = ifft(Y) * (num / n)
    return y if x.is_complex() else y.real


def phase_main_bluestein(card: str):
    """The Bluestein main path: fft_any at n = 1000 and 4097, ifft_any and
    planar.fft_any at 1000, resample of (131072, 1000) real rows to
    RESAMPLE_TO samples.  Every row against the plain version (resample:
    against float64), the first rows against float64.  Returns (rows,
    calls, worst error against the plain version)."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.bluestein import _conv_length
    from smfft_tpu_torch.ops import chirp as CH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    calls = 0
    worst = 0.0

    for n, b in BLUESTEIN_MAIN.items():
        m = _conv_length(2 * n - 1)
        x = rand_complex(b, n, gen)
        nbytes = 16.0 * b * n
        flops = b * 10.0 * m * math.log2(m)
        head = x[:ORACLE_ROWS].to(torch.complex128)
        fwd = torch.complex(*CH.bluestein_plain(x.real, x.imag, n, m))
        y = T.fft_any(x)
        calls += 1
        worst = max(worst, check_all(y, fwd, m, f"fft_any n={n}"))
        check_all(y[:ORACLE_ROWS], torch.fft.fft(head), m, f"fft_any n={n}",
                  against="float64 torch.fft")
        del y
        rows.append(time_path(
            f"fft_any n={n} batch={b}", card, lambda: T.fft_any(x),
            lambda: CH.bluestein_plain(x.real, x.imag, n, m),
            lambda: torch.fft.fft(x), "torch.fft.fft", x, nbytes, flops))
        calls += 1 + REPS_CONV
        if n == 1000:
            y = T.ifft_any(x)
            calls += 1
            worst = max(worst, check_all(y, torch.complex(
                *CH.bluestein_plain(x.real, x.imag, n, m, inverse=True,
                                    scale=1.0 / n)), m, f"ifft_any n={n}"))
            check_all(y[:ORACLE_ROWS], torch.fft.ifft(head), m,
                      f"ifft_any n={n}", against="float64 torch.fft")
            del y
            rows.append(time_path(
                f"ifft_any n={n} batch={b}", card, lambda: T.ifft_any(x),
                lambda: CH.bluestein_plain(x.real, x.imag, n, m,
                                           inverse=True, scale=1.0 / n),
                lambda: torch.fft.ifft(x), "torch.fft.ifft", x, nbytes,
                flops))
            calls += 1 + REPS_CONV
            np_ = CH.n_pad(n)
            vr = torch.zeros((b, np_), device="cuda")
            vi = torch.zeros_like(vr)
            vr[:, :n], vi[:, :n] = x.real, x.imag
            o_r, o_i = T.planar.fft_any(vr, vi, n=n)
            calls += 1
            worst = max(worst, check_all(
                (o_r[:, :n], o_i[:, :n]), (fwd.real, fwd.imag), m,
                f"planar.fft_any n={n}"))
            if o_r[:, n:].any() or o_i[:, n:].any():
                fail("planar.fft_any: the pad lanes are not zero")
            del o_r, o_i
            rows.append(time_path(
                f"planar.fft_any n={n} batch={b}", card,
                lambda: T.planar.fft_any(vr, vi, n=n),
                lambda: CH.bluestein_plain(vr, vi, n, m),
                lambda: torch.fft.fft(x), "torch.fft.fft", vr,
                16.0 * b * np_, flops))
            calls += 1 + REPS_CONV
            del vr, vi
            # resample real rows: B16 twice (n -> spectrum, num -> samples)
            xr = torch.rand((b, n), generator=gen, device="cuda") - 0.5
            num = RESAMPLE_TO
            mi = _conv_length(2 * num - 1)
            y = T.resample(xr, num)
            calls += 2
            want = resample_ref(xr, num, lambda a: torch.fft.fft(a.double()),
                                torch.fft.ifft)
            check_all(y, want, m, f"resample {n} -> {num}",
                      against="float64 (scipy's semantics)")
            del y, want
            zeros = torch.zeros_like(xr)
            rows.append(time_path(
                f"resample {n} -> {num} batch={b}", card,
                lambda: T.resample(xr, num),
                lambda: resample_ref(
                    xr, num,
                    lambda a: torch.complex(*CH.bluestein_plain(
                        a, zeros, n, m)),
                    lambda a: torch.complex(*CH.bluestein_plain(
                        a.real.contiguous(), a.imag.contiguous(), num, mi,
                        inverse=True, scale=1.0 / num))),
                lambda: resample_ref(xr, num, torch.fft.fft,
                                     torch.fft.ifft),
                "the torch.fft composition", xr, 4.0 * b * (n + num),
                b * 10.0 * (m * math.log2(m) + mi * math.log2(mi))))
            calls += 2 * (1 + REPS_CONV)
            del xr, zeros
        del x, fwd
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


HUGE_SIZES = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 20, 1 << 22, 1 << 24,
              1 << 28)
# the named plans beside the default ones of HUGE_SIZES, one size each
HUGE_PLANS = ((1 << 20, "two:fold"), (1 << 20, "three"), (1 << 24, "five"))
REAL_HUGE = ((1 << 15, ("pair", "halfc")), (1 << 20, ("pair", "halfc")),
             (1 << 24, ("pair", "halfc")), (1 << 29, ("halfc",)))
# the plan table: the plans timed at each N with 2^27 points a call
PLAN_TABLE = ((1 << 18, ("two:revisit", "three")),
              (1 << 20, ("two:revisit", "three")),
              (1 << 21, ("two:revisit", "three", "five")),
              (1 << 22, ("three", "five")), (1 << 24, ("three", "five")),
              (1 << 26, ("three", "five")), (1 << 28, ("three", "five")))


def huge_oracle(x: torch.Tensor, inverse: bool, scale: float) -> torch.Tensor:
    return oracle(x, inverse) * scale


def phase_huge_sweep(card: str):
    """fourstep_pass_kernel through every huge-N plan and size, and the
    real transforms in both modes (the pair split in the last pass to
    radix 256, real_huge_kernel's other splits and the merges), against
    the plain versions (every row) and float64 torch.fft, both tiers;
    "exact" within 2 ulp(max|X|).  Then the plan table: each plan's time
    at 2^27 points a call.  Returns
    ({kernel: max |kernel - plain|}, worst "exact" ulp, plan table)."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.ops import hugefft
    from smfft_tpu_torch.ops import real as R
    from smfft_tpu_torch.ops import real_fused as RF
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = {"fourstep_pass": 0.0, "real_huge": 0.0}
    worst_ulp = 0.0
    cases = [(n, None) for n in HUGE_SIZES] + list(HUGE_PLANS)
    for n, plan in cases:
        b = max(1, SWEEP_POINTS // n)
        passes = (FF.default_passes(n) if plan is None
                  else hugefft.passes(n, plan))
        x = rand_complex(b, n, gen)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        line = []
        for inverse in (False, True):
            scale = 1.0 / n if inverse else 1.0
            want = huge_oracle(x[:ORACLE_ROWS], inverse, scale)
            u = ulp(want.abs().max().item())
            for exact in (False, True):
                kw = dict(inverse=inverse, scale=scale, exact=exact)
                plain = torch.complex(*FF.transform_plain(xr, xi, n, passes,
                                                          **kw))
                got_c = FF.run_passes(x, n, passes, **kw)
                got_p = torch.complex(*FF.run_passes((xr, xi), n, passes,
                                                     **kw))
                torch.cuda.synchronize()
                e = max(max_err(got_c, plain), max_err(got_p, plain))
                o64 = max(max_err(got_c[:ORACLE_ROWS], want),
                          max_err(got_p[:ORACLE_ROWS], want))
                del got_c, got_p, plain
                lim = bound(n) * (scale if inverse else 1.0)
                if max(e, o64) > lim:
                    fail(f"fourstep n={n} plan={plan} inverse={inverse} "
                         f"exact={exact}: {e:.3e} / {o64:.3e} over {lim:.3e}")
                if exact and o64 > 2 * u:
                    fail(f"fourstep n={n} plan={plan}: 'exact' is "
                         f"{o64 / u:.2f} ulp(max|X|) from float64")
                worst["fourstep_pass"] = max(worst["fourstep_pass"],
                                             e / (scale if inverse else 1.0))
                if exact:
                    worst_ulp = max(worst_ulp, o64 / u)
                line.append(f"{'inv' if inverse else 'fwd'} "
                            f"{'exact' if exact else 'highest'} {e:.2e}/"
                            f"{o64:.2e} ({o64 / u:.2f} ulp)")
                torch.cuda.empty_cache()
        print(f"fourstep N=2^{n.bit_length() - 1} plan "
              f"{plan or 'default'} {[p.radix for p in passes]} b={b} "
              "(complex64 and planar; vs plain / vs float64): "
              + ", ".join(line))
        del x, xr, xi
        torch.cuda.empty_cache()
    for n, modes in REAL_HUGE:
        b = 1 if n > 1 << 28 else 2
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        want = torch.fft.rfft(x[:ORACLE_ROWS].double())
        u_fwd = ulp(want.abs().max().item())
        line = []
        for mode in modes:
            for exact in (False, True):
                layout = "numpy" if n == 1 << 20 else "planar"
                got = RF.rfft_large_rows(x, layout, exact, mode)
                gt = got if isinstance(got, tuple) else (got, None)
                plain = RF.rfft_large_plain(x, layout, exact, mode)
                pt = plain if isinstance(plain, tuple) else (plain,)
                e = max(max_err(g, q) for g, q in zip(gt, pt))
                del plain, pt
                nat = R.to_layout(*R.from_layout(*gt, layout, n // 2),
                                  "numpy")
                o64 = max_err(nat[:ORACLE_ROWS], want)
                del nat
                back = RF.irfft_large_rows(*gt, n, layout, exact,
                                           2.0 / n, mode)
                pback = RF.irfft_large_plain(*gt, n, layout, exact, 2.0 / n,
                                             mode)
                torch.cuda.synchronize()
                e_inv = max_err(back, pback)
                o_inv = max_err(back, x)
                del got, gt, back, pback
                if max(e, o64, e_inv, o_inv) > bound(n):
                    fail(f"real_huge n={n} {mode} exact={exact}: "
                         f"{e:.3e} / {o64:.3e} / {e_inv:.3e} / {o_inv:.3e}")
                if exact and o64 > 2 * u_fwd:
                    fail(f"real_huge n={n} {mode}: 'exact' is "
                         f"{o64 / u_fwd:.2f} ulp(max|X|) from float64")
                worst["real_huge"] = max(worst["real_huge"], e, e_inv)
                if exact:
                    worst_ulp = max(worst_ulp, o64 / u_fwd)
                line.append(f"{mode} {'exact' if exact else 'highest'} "
                            f"{e:.2e}/{o64:.2e} ({o64 / u_fwd:.2f} ulp), "
                            f"inverse {e_inv:.2e}/{o_inv:.2e}")
                torch.cuda.empty_cache()
        print(f"real_huge n=2^{n.bit_length() - 1} b={b} (vs plain / vs "
              "float64; inverse vs plain / vs x): " + "; ".join(line))
        del x, want
        torch.cuda.empty_cache()
    table = []
    for n, plans in PLAN_TABLE:
        b = max(1, MAIN_POINTS // n)
        x = rand_complex(b, n, gen)
        row = {"n": n, "batch": b}
        for plan in plans:
            passes = hugefft.passes(n, plan)
            row[plan] = cuda_ms(lambda: FF.run_passes(x, n, passes),
                                reps=REPS_CONV)
        table.append(row)
        print(f"plan table N=2^{n.bit_length() - 1} batch={b} ({card}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()
                          if k not in ("n", "batch"))
              + f" (default {hugefft.default_plan(n)})")
        del x
        torch.cuda.empty_cache()
    print(f"huge-N sweep: max |kernel - plain| fourstep_pass "
          f"{worst['fourstep_pass']:.3e} (relative to the scale), real_huge "
          f"{worst['real_huge']:.3e}; 'exact' at most {worst_ulp:.2f} ulp")
    return worst, worst_ulp, table


def phase_main_huge(card: str):
    """The huge-N main path at 2^27 points or samples a call: fft_large at
    N = 2^15 / 2^20 / 2^24 / 2^27, ifft_large at 2^20, planar.rfft_large /
    irfft_large at n = 2^20 / 2^27, one fft_large backward at 2^20.  Every
    row against the plain version, the first rows against float64.
    Returns (rows, expected launches, worst error against the plain
    version)."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.ops import real_fused as RF
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = []
    calls = {"fourstep_pass": 0, "real_huge": 0}
    worst = {"fourstep_pass": 0.0, "real_huge": 0.0}

    for n in (1 << 15, 1 << 20, 1 << 24, 1 << 27):
        b = MAIN_POINTS // n
        x = rand_complex(b, n, gen)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        passes = FF.default_passes(n)
        plain = torch.complex(*FF.transform_plain(xr, xi, n, passes))
        y = T.fft_large(x)
        calls["fourstep_pass"] += len(passes)
        check_rows(y, x, False, None, f"fft_large N=2^{n.bit_length() - 1}")
        worst["fourstep_pass"] = max(worst["fourstep_pass"], check_all(
            y, plain, n, f"fft_large N=2^{n.bit_length() - 1}"))
        del y, plain
        what = (f"fft_large N=2^{n.bit_length() - 1} batch={b} "
                f"({len(passes)} passes {[p.radix for p in passes]})")
        rows.append(time_path(
            what, card, lambda: T.fft_large(x),
            lambda: FF.transform_plain(xr, xi, n, passes),
            lambda: torch.fft.fft(x), "torch.fft.fft", x,
            16.0 * MAIN_POINTS, 5.0 * MAIN_POINTS * math.log2(n)))
        rows[-1]["n"] = n
        calls["fourstep_pass"] += len(passes) * (1 + REPS_CONV)
        if n == 1 << 20:
            y = T.ifft_large(x)
            calls["fourstep_pass"] += len(passes)
            check_rows(y, x, True, 1.0 / n, "ifft_large N=2^20")
            worst["fourstep_pass"] = max(worst["fourstep_pass"], n * check_all(
                y, torch.complex(*FF.transform_plain(
                    xr, xi, n, passes, inverse=True, scale=1.0 / n)), n,
                "ifft_large N=2^20", bound(n) / n))
            del y
            rows.append(time_path(
                f"ifft_large N=2^20 batch={b}", card,
                lambda: T.ifft_large(x),
                lambda: FF.transform_plain(xr, xi, n, passes, inverse=True,
                                           scale=1.0 / n),
                lambda: torch.fft.ifft(x), "torch.fft.ifft", x,
                16.0 * MAIN_POINTS, 5.0 * MAIN_POINTS * math.log2(n)))
            rows[-1]["n"] = n
            calls["fourstep_pass"] += len(passes) * (1 + REPS_CONV)
            ms_exact = cuda_ms(lambda: T.fft_large(x, precision="exact"),
                               reps=REPS_CONV)
            calls["fourstep_pass"] += len(passes) * (1 + REPS_CONV)
            rows[-1]["fft_large_exact_ms"] = ms_exact
            print(f"  fft_large N=2^20 precision='exact' ({card}): "
                  f"{ms_exact:.4f} ms")
            # one backward: |fft_large(x)|^2 summed, against torch.fft's
            xg = x.clone().requires_grad_(True)
            (T.fft_large(xg).abs() ** 2).sum().backward()
            calls["fourstep_pass"] += 2 * len(passes)
            x64 = x[:ORACLE_ROWS].to(torch.complex128).requires_grad_(True)
            (torch.fft.fft(x64).abs() ** 2).sum().backward()
            g = xg.grad
            e = max_err(g[:ORACLE_ROWS], x64.grad) / x64.grad.abs().max()
            print(f"  fft_large N=2^20 backward: first {ORACLE_ROWS} rows' "
                  f"gradient within {e.item():.3e} of torch.fft's (relative)")
            if not e.item() < 1e-5 or g.shape != x.shape:
                fail("fft_large backward disagrees with torch.fft's")
            del xg, x64, g
            # the JAX package's strided two-pass (B22 / B23), 1024 x 1024
            fac = FF.factors_plan(1024, 1024)
            o_r, o_i = FF.fft_large_planar(xr, xi, factors=(1024, 1024))
            calls["fourstep_pass"] += len(fac)
            got = torch.complex(o_r, o_i)
            del o_r, o_i
            check_rows(got, x, False, None,
                       "fft_large_planar factors=(1024, 1024) N=2^20")
            worst["fourstep_pass"] = max(worst["fourstep_pass"], check_all(
                got, torch.complex(*FF.transform_plain(xr, xi, n, fac)), n,
                "fft_large_planar factors=(1024, 1024) N=2^20"))
            del got
            rows.append(time_path(
                f"fft_large_planar factors=(1024, 1024) N=2^20 batch={b} "
                "(B22 + B23)", card,
                lambda: FF.fft_large_planar(xr, xi, factors=(1024, 1024)),
                lambda: FF.transform_plain(xr, xi, n, fac),
                lambda: torch.fft.fft(x), "torch.fft.fft", x,
                16.0 * MAIN_POINTS, 5.0 * MAIN_POINTS * math.log2(n)))
            rows[-1]["n"] = n
            calls["fourstep_pass"] += len(fac) * (1 + REPS_CONV)
        del x, xr, xi
        torch.cuda.empty_cache()
    for n in (1 << 20, 1 << 27):
        b = MAIN_POINTS // n
        L = n // 2
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        mode = RF.choose_mode(b, n)
        npass = len(FF.default_passes(n if mode == "pair" else L))
        # the forward's split: a real_huge launch, or the last pass's in
        # pair mode to radix 256
        split = int(mode == "halfc"
                    or not FF.pair_split_plan(n)[-1].split)
        hr, hi = T.planar.rfft_large(x)
        calls["fourstep_pass"] += npass
        calls["real_huge"] += split
        tag = f"n=2^{n.bit_length() - 1} batch={b} {mode} ({npass} passes)"
        worst["real_huge"] = max(worst["real_huge"], check_all(
            (hr, hi), RF.rfft_large_plain(x, "planar", mode=mode), n,
            f"planar.rfft_large {tag}"))
        want = torch.fft.rfft(x[:ORACLE_ROWS].double())
        head = torch.complex(hr[:ORACLE_ROWS], hi[:ORACLE_ROWS])
        e64 = max((head[:, 1:] - want[:, 1:L]).abs().max().item(),
                  (hr[:ORACLE_ROWS, 0] - want[:, 0].real).abs().max().item(),
                  (hi[:ORACLE_ROWS, 0] - want[:, L].real).abs().max().item())
        print(f"  planar.rfft_large {tag}: first rows vs float64 {e64:.3e}")
        if e64 > bound(n):
            fail(f"planar.rfft_large n={n}: over bound against float64")
        del head, want
        rows.append(time_path(
            f"planar.rfft_large {tag}", card, lambda: T.planar.rfft_large(x),
            lambda: RF.rfft_large_plain(x, "planar", mode=mode),
            lambda: torch.fft.rfft(x), "torch.fft.rfft", x,
            8.0 * MAIN_POINTS, MAIN_POINTS * (2.5 * math.log2(n) + 5.0)))
        rows[-1]["n"] = n
        calls["fourstep_pass"] += npass * (1 + REPS_CONV)
        calls["real_huge"] += split * (1 + REPS_CONV)
        back = T.planar.irfft_large(hr, hi)
        calls["fourstep_pass"] += npass
        calls["real_huge"] += 1
        worst["real_huge"] = max(worst["real_huge"], check_all(
            back, RF.irfft_large_plain(hr, hi, n, "planar", scale=1.0 / L,
                                       mode=mode), n,
            f"planar.irfft_large {tag}"))
        err = (back - x).abs().max().item()
        print(f"  planar.rfft_large -> planar.irfft_large: max |x' - x| "
              f"{err:.3e}")
        if err > bound(n):
            fail("huge-N real round trip over bound")
        del back
        spec = torch.fft.rfft(x)
        rows.append(time_path(
            f"planar.irfft_large {tag}", card,
            lambda: T.planar.irfft_large(hr, hi),
            lambda: RF.irfft_large_plain(hr, hi, n, "planar", scale=1.0 / L,
                                         mode=mode),
            lambda: torch.fft.irfft(spec, n), "torch.fft.irfft", x,
            8.0 * MAIN_POINTS, MAIN_POINTS * (2.5 * math.log2(n) + 5.0)))
        rows[-1]["n"] = n
        calls["fourstep_pass"] += npass * (1 + REPS_CONV)
        calls["real_huge"] += 1 + REPS_CONV
        del x, hr, hi, spec
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, calls, worst


def real_huge_alone(card: str) -> dict:
    """real_huge_kernel alone on the main path's shapes (the pair split of
    128 rows of 2^20 samples; timed after the path's counters are read):
    time, the plain split, the bound (8 bytes a real sample)."""
    from smfft_tpu_torch.ops import real_fused as RF
    n, b = 1 << 20, MAIN_POINTS // (1 << 20)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    z = rand_complex(b // 2, n, gen)
    spec = tuple(torch.empty((b, n // 2), device="cuda") for _ in range(2))
    row = time_path(
        f"real_huge pair split alone, 2^27 samples (b={b}, n=2^20)", card,
        lambda: RF.launch_real_huge("pair_split", z, spec, n),
        lambda: RF.pair_split_plain(z, b), lambda: None, "none", z,
        8.0 * MAIN_POINTS, 10.0 * MAIN_POINTS)
    del z, spec
    torch.cuda.empty_cache()
    return row


# the fused tail's sizes (2^30 samples a call) and ROADMAP C.5's CPU
# figures: ulp(max|X|) of fft_large, (b, N) with b N = 2^20, in the JAX
# package (backend="xla") and in the port's plain version
TAIL_SIZES = tuple(1 << k for k in range(21, 27))
C5_CPU_ULP = {"reference": {15: 3.13, 18: 2.74, 20: 3.42, 22: 3.54},
              "port plain": {15: 6.49, 18: 4.61, 20: 4.36, 22: 5.17}}


def three_launches(x: torch.Tensor, layout: str = "numpy"):
    """The pair-mode R2C of real rows x (even batch) as the three launches
    of ``pair_split_plan``, the last with the split."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.ops import real_fused as RF
    b, n = x.shape
    b2 = b // 2
    plan = FF.pair_split_plan(n)
    tmp = FF.launch_pass((x[:b2], x[b2:]), lambda: torch.empty(
        (b2, n), dtype=torch.complex64, device=x.device), n, plan[0])
    for p in plan[1:-1]:
        FF.launch_pass(tmp, tmp, n, p)
    return FF.launch_pass(tmp, RF._alloc_spec(layout, b, n // 2, x.device),
                          n, plan[-1])


def phase_fused_tail(card: str) -> list:
    """The pair-mode R2C (numpy layout, 2^30 samples a call) at N = 2^21
    .. 2^26 on its main path, pass 1 and the fused tail where it fits,
    against the three launches of ``pair_split_plan``: each call's
    launches and the split items that waited, ms of both, and both against
    float64 on the first rows (``rfft_large_err`` = max|X - X64| /
    rms(X64), the benchmark's; ulp(max|X|)).  Returns the rows."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.ops import real_fused as RF
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows = []
    for n in TAIL_SIZES:
        b = (1 << 30) // n
        x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
        tail = any(p.then for p in FF.tail_plan(n, FF.pair_split_plan(n)))
        c0, w0 = counts()["fourstep_pass"], FF.tail_waits()
        got = RF.rfft_large_rows(x, "numpy", mode="pair")
        torch.cuda.synchronize()
        launched = counts()["fourstep_pass"] - c0
        waits = FF.tail_waits() - w0
        ref = three_launches(x)
        head = min(b, 4)
        want = torch.fft.rfft(x[:head].double())
        rms = want.abs().square().mean().sqrt().item()
        u = ulp(want.abs().max().item())
        e_got, e_ref = max_err(got[:head], want), max_err(ref[:head], want)
        apart = max_err(got, ref) / ulp(ref.abs().max().item())
        del got, ref, want
        ms_main = cuda_ms(lambda: RF.rfft_large_rows(x, "numpy", mode="pair"),
                          reps=REPS_CONV)
        ms_three = cuda_ms(lambda: three_launches(x), reps=REPS_CONV)
        k = n.bit_length() - 1
        row = {"n": n, "batch": b, "tail": tail, "launches": launched,
               "waits": waits, "ms": ms_main, "three_ms": ms_three,
               "rfft_large_err": e_got / rms, "three_err": e_ref / rms,
               "ulp": e_got / u, "three_ulp": e_ref / u,
               "ulp_apart": apart}
        rows.append(row)
        cpu = ", ".join(f"{w} {f[k]:.2f}" for w, f in C5_CPU_ULP.items()
                        if k in f)
        print(f"  pair R2C n=2^{k} batch={b} ({card}): "
              f"{'pass 1 + fused tail' if tail else 'three launches'} "
              f"{ms_main:.4f} ms ({launched} launches, {waits} split items "
              f"waited), three launches {ms_three:.4f} ms; rfft_large_err "
              f"{row['rfft_large_err']:.3e} / {row['three_err']:.3e}, "
              f"{row['ulp']:.2f} / {row['three_ulp']:.2f} ulp(max|X|), "
              f"{apart:.2f} ulp apart"
              + (f" (C.5, CPU fft_large at 2^{k}: {cpu})" if cpu else ""))
        if launched != (2 if tail else 3):
            fail(f"pair R2C n={n}: {launched} launches")
        if max(row["rfft_large_err"], row["three_err"]) > 2e-4:
            fail(f"pair R2C n={n}: over the benchmark's limit")
        # the two plans round differently (tests/test_torch_cuda.py
        # test_fused_tail_matches_the_three_launches)
        if apart > 8:
            fail(f"pair R2C n={n}: {apart:.2f} ulp from the three launches")
        del x
        torch.cuda.empty_cache()
    print("fused tail rows: " + json.dumps({"card": card, "rows": rows}))
    return rows


# ---------------------------------------------------------------------------
# Phases 17-18: the N-D transforms and the DCT / DST (ndim.py, dct.py),
# compositions over the C2C, R2C and C2R kernels
# ---------------------------------------------------------------------------

# the supported lengths of each DCT / DST type (the kernels' contracts)
DCT_SIZES = {2: [1 << k for k in range(6, 15)],
             3: [1 << k for k in range(6, 15)],
             4: [1 << k for k in range(4, 14)]}
DCT1_SIZES = {"dct": [(1 << k) + 1 for k in range(5, 13)],
              "dst": [(1 << k) - 1 for k in range(5, 13)]}
ND_SWEEP_POINTS = 1 << 16
ND_ORACLE_IMAGES = 4
# phase 18's shapes, each 2^27 points or samples: images (count, side),
# one wide image, a cube's side, type 4's rows, and the rows of n = 1024
# (hfft / ihfft, DCT / DST types 1-3)
ND_IMAGES, ND_SIDE = 128, 1024
ND_WIDE = (8192, 16384)
ND_CUBE = 512
ND_DCT4 = (16384, 8192)
ND_ROWS = 131072


@contextlib.contextmanager
def plain_on_card():
    """Inside: every kernel wrapper's dispatch takes the plain PyTorch
    version, on the card, so that a composed entry point (fft2, dct, ...)
    computes its plain version on the same CUDA tensors and launches no
    kernel.  The checker's reference only; the package has no such
    switch."""
    from smfft_tpu_torch.ops import c2c as C
    saved = C.is_cpu
    C.is_cpu = lambda t: True
    try:
        yield
    finally:
        C.is_cpu = saved


@contextlib.contextmanager
def dct_over_torch_fft():
    """Inside: smfft_tpu_torch.dct runs its recipes (Makhoul's reorder,
    the symmetric extensions, the eighth-wave twiddles) over torch.fft's
    rfft / irfft / fft: the composition a DCT row is timed against (no
    single PyTorch call computes a DCT)."""
    import importlib
    import types
    from smfft_tpu_torch import api
    TD = importlib.import_module("smfft_tpu_torch.dct")
    shim = types.SimpleNamespace(
        _as_real=api._as_real,
        rfft=lambda v, backend=None, precision=None: torch.fft.rfft(v),
        irfft=lambda s, n, backend=None, precision=None, norm=None:
            torch.fft.irfft(s, n=n, norm=norm),
        fft=lambda a, backend=None, precision=None: torch.fft.fft(a))
    saved = TD.api
    TD.api = shim
    try:
        yield
    finally:
        TD.api = saved


def dct_length(name: str, t: int, n: int) -> int:
    """The length of the kernel a DCT / DST of type t and size n runs."""
    if t == 1:
        return 2 * (n - 1) if name.lstrip("i").startswith("dct") \
            else 2 * (n + 1)
    return 2 * n if t == 4 else n


def rel_check(got, want, lim: float, what: str) -> float:
    """max |got - want| / max |want| within lim; returns it."""
    err = max_err(got, want) / want.abs().max().item()
    if not err <= lim:
        fail(f"{what}: relative error {err:.3e} over {lim:.3e}")
    return err


def phase_ndim_sweep():
    """fftn / ifftn over one, two and three axes (a middle axis among
    them), rfft2 -> irfft2 and rfftn -> irfftn, hfft / ihfft with n and
    three norms, every DCT / DST type at every supported n and both norms,
    dctn / idstn over two axes; each against the same call on a CPU copy
    (the plain versions) and a float64 oracle on the CPU (torch.fft,
    scipy.fft), within the summed bound(m) * max|ref|; fft2 "exact"
    within 2 ulp(max|X|) an axis.  Returns the worst relative error
    against the plain versions."""
    import scipy.fft
    import smfft_tpu_torch as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    worst, count = 0.0, 0

    def both(what, fn, x, oracle, lim):
        nonlocal worst, count
        got = fn(x)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                   else got).all()):
            fail(f"{what}: non-finite output")
        plain = fn(x.cpu())
        if got.shape != plain.shape or got.dtype != plain.dtype:
            fail(f"{what}: {tuple(got.shape)} {got.dtype} against the plain "
                 f"version's {tuple(plain.shape)} {plain.dtype}")
        worst = max(worst, rel_check(got.cpu(), plain, lim, what + " vs plain"))
        rel_check(got.cpu(), oracle(x.cpu()), lim, what + " vs float64")
        count += 1
        return got

    c3 = rand_complex(32 * 64, 128, gen).reshape(32, 64, 128)
    c64 = lambda a: a.to(torch.complex128)  # noqa: E731
    for axes, lim in ((1, bound(64)), ((-2, -1), bound(64) + bound(128)),
                      (None, bound(32) + bound(64) + bound(128))):
        both(f"fftn axes={axes}", lambda a: T.fftn(a, axes=axes), c3,
             lambda a: torch.fft.fftn(c64(a), dim=axes), lim)
        both(f"ifftn axes={axes}", lambda a: T.ifftn(a, axes=axes), c3,
             lambda a: torch.fft.ifftn(c64(a), dim=axes), lim)
    both("fft2", T.fft2, c3, lambda a: torch.fft.fft2(c64(a)),
         bound(64) + bound(128))
    both("ifft2 norm=None", lambda a: T.ifft2(a, norm=None), c3,
         lambda a: torch.fft.ifft2(c64(a)) * (64 * 128),
         bound(64) + bound(128))
    # "exact": 2 ulp(max|X|) a pass
    got = T.fft2(c3, precision="exact").cpu()
    want = torch.fft.fft2(c64(c3.cpu()))
    e = max_err(got, want) / ulp(want.abs().max().item())
    print(f"  fft2 exact: {e:.2f} ulp(max|X|) from float64 (limit 4)")
    if not e <= 4:
        fail(f"fft2 exact: {e:.2f} ulp(max|X|), over 2 a pass")
    del c3

    for shape, axes in (((4, 64, 256), (-2, -1)),
                        ((2, 32, 64, 128), (1, 2, 3))):
        x = torch.rand(shape, generator=gen, device="cuda") - 0.5
        lim = sum(bound(shape[a]) for a in axes)
        spec = both(f"rfftn {shape} axes={axes}",
                    lambda a: T.rfftn(a, axes=axes), x,
                    lambda a: torch.fft.rfftn(a.double(), dim=axes), lim)
        both(f"rfft2 {shape} axes={axes[-2:]}",
             lambda a: T.rfft2(a, axes=axes[-2:]), x,
             lambda a: torch.fft.rfft2(a.double(), dim=axes[-2:]),
             sum(bound(shape[a]) for a in axes[-2:]))
        back = both(f"irfftn {shape} axes={axes}",
                    lambda a: T.irfftn(a, axes=axes), spec,
                    lambda a: torch.fft.irfftn(c64(a), dim=axes,
                                               s=[shape[k] for k in axes]),
                    lim)
        rel_check(back, x, 2 * lim, f"rfftn -> irfftn {shape} round trip")
        both(f"irfft2 {shape}",
             lambda a: T.irfft2(a, axes=axes[-2:]),
             T.rfft2(x, axes=axes[-2:]),
             lambda a: torch.fft.irfft2(c64(a), dim=axes[-2:]),
             sum(bound(shape[a]) for a in axes[-2:]))
        del x, spec, back
    h = rand_complex(64, 257, gen)
    xr = torch.rand((64, 512), generator=gen, device="cuda") - 0.5
    for n in (None, 256, 1024):
        for norm in (None, "ortho", "forward"):
            m = n or 512
            both(f"hfft n={n} norm={norm}",
                 lambda a: T.hfft(a, n=n, norm=norm), h,
                 lambda a: torch.fft.hfft(c64(a), n=n, norm=norm), bound(m))
            both(f"ihfft n={n} norm={norm}",
                 lambda a: T.ihfft(a, n=n, norm=norm), xr,
                 lambda a: torch.fft.ihfft(a.double(), n=n, norm=norm),
                 bound(m))
    del h, xr

    def scipy_oracle(name, **kw):
        return lambda a: torch.from_numpy(getattr(scipy.fft, name)(
            a.double().numpy(), **kw))

    for name in ("dct", "idct", "dst", "idst"):
        family = name.lstrip("i")
        for t in (1, 2, 3, 4):
            sizes = DCT1_SIZES[family] if t == 1 else DCT_SIZES[t]
            for n in sizes:
                rows = max(4, ND_SWEEP_POINTS // n // 4 * 4)
                x = torch.rand((rows, n), generator=gen, device="cuda") - 0.5
                for norm in (None, "ortho"):
                    fn = getattr(T, name)
                    both(f"{name} type {t} n={n} norm={norm}",
                         lambda a: fn(a, type=t, norm=norm), x,
                         scipy_oracle(name, type=t, norm=norm),
                         bound(dct_length(name, t, n)))
                del x
    x = torch.rand((4, 64, 256), generator=gen, device="cuda") - 0.5
    for name in ("dctn", "idstn"):
        for norm in (None, "ortho"):
            fn = getattr(T, name)
            both(f"{name} axes=(-2, -1) norm={norm}",
                 lambda a: fn(a, axes=(-2, -1), norm=norm), x,
                 scipy_oracle(name, axes=(-2, -1), norm=norm),
                 bound(64) + bound(256))
    del x
    torch.cuda.empty_cache()
    print(f"ndim / DCT sweep: {count} calls, worst relative error against "
          f"the plain versions {worst:.3e}")
    return worst


def phase_main_ndim(card: str):
    """The N-D / DCT main path at 2^27 points or samples a call (the table
    below): each call once checked (every element against its plain
    version on the card, the first images or rows against a float64
    oracle) and timed (median of REPS_CONV CUDA-event runs) beside a
    same-run copy_ of its input, the bound (bytes in + out over the
    card's memory rate), torch.fft's call where one computes the same
    function, else the same recipe over torch.fft ("none").  Returns
    (rows, expected launches, {kernel shapes to time alone}, worst
    relative error against the plain versions)."""
    import importlib
    import scipy.fft
    import smfft_tpu_torch as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    expected = {"c2c": 0, "r2c": 0, "c2r": 0, "fourstep_pass": 0}
    rows, worst = [], 0.0
    TD = importlib.import_module("smfft_tpu_torch.dct")

    def counted(fn, per_call):
        def run():
            for k, v in per_call.items():
                expected[k] += v
            return fn()
        return run

    def path(what, fn, per_call, x, nbytes, kernels, oracle, head, lim,
             library=None, library_name="none", composition=None):
        nonlocal worst
        run = counted(fn, per_call)
        y = run()
        torch.cuda.synchronize()
        with plain_on_card():
            plain = fn()
        err = check_all(y, plain, 0, what, lim=lim * plain.abs().max().item())
        worst = max(worst, err / plain.abs().max().item())
        del plain
        want = oracle(head(x))
        e64 = max_err(head(y).cpu() if want.device.type == "cpu"
                      else head(y), want) / want.abs().max().item()
        print(f"  {what}: the oracle's part vs float64 {e64:.3e} relative "
              f"(limit {lim:.3e})")
        if not e64 <= lim:
            fail(f"{what}: error against float64 over the bound")
        del y, want
        torch.cuda.empty_cache()
        ms = cuda_ms(run, reps=REPS_CONV)
        dst = torch.empty_like(x)
        ms_copy = cuda_ms(lambda: dst.copy_(x), reps=REPS_CONV)
        del dst
        ms_lib = cuda_ms(library, reps=REPS_CONV) if library else None
        if composition is not None:
            with dct_over_torch_fft():
                ms_comp = cuda_ms(composition, reps=REPS_CONV)
        else:
            ms_comp = None
        torch.cuda.empty_cache()
        bound_ms = least_ms(nbytes, 0.0)[0]
        row = {"what": what, "shape": list(x.shape), "ms": ms,
               "copy_ms": ms_copy, "bound_ms": bound_ms, "bound_by": "bytes",
               "library": library_name, "library_ms": ms_lib,
               "composition_ms": ms_comp, "launches": per_call,
               "kernels": kernels}
        rows.append(row)
        ref = ms_lib if ms_lib is not None else ms_comp
        print(f"{what} ({card}): {ms:.4f} ms | copy_ of the input "
              f"{ms_copy:.4f} ms | bound {bound_ms:.4f} ms, at "
              f"{bound_ms / ms:.3f} | {library_name} "
              + (f"{ms_lib:.4f} ms" if ms_lib is not None else
                 f"(composition over torch.fft {ms_comp:.4f} ms)")
              + f" | {ms / ref:.2f}x")

    c64 = lambda a: a.to(torch.complex128)  # noqa: E731
    first = lambda a: a[:ND_ORACLE_IMAGES]  # noqa: E731
    rows64 = lambda a: a[:ORACLE_ROWS]  # noqa: E731

    def sp(name, **kw):
        return lambda a: torch.from_numpy(getattr(scipy.fft, name)(
            a.cpu().double().numpy(), **kw))

    # images: C2C passes over rows of ND_SIDE, real ones over half spectra
    b3, n2 = ND_IMAGES, ND_SIDE
    pts = b3 * n2 * n2
    bins = b3 * n2 * (n2 // 2 + 1)
    lim = 2 * bound(n2)
    x = rand_complex(b3 * n2, n2, gen).reshape(b3, n2, n2)
    for name, inverse in (("fft2", False), ("ifft2", True)):
        path(f"{name} {tuple(x.shape)} complex64",
             lambda: getattr(T, name)(x), {"c2c": 1, "fourstep_pass": 1}, x,
             16.0 * pts,
             [("c2c", b3 * n2, n2, inverse),
              ("fourstep_pass", b3, (n2, n2), inverse)],
             lambda a: getattr(torch.fft, name)(c64(a)), first, lim,
             lambda: getattr(torch.fft, name)(x), f"torch.fft.{name}")
    del x
    torch.cuda.empty_cache()
    x = rand_complex(*ND_WIDE, gen)
    path(f"fftn {ND_WIDE} complex64, one image", lambda: T.fftn(x),
         {"c2c": 1, "fourstep_pass": 1}, x, 16.0 * x.numel(),
         [("c2c", ND_WIDE[0], ND_WIDE[1], False),
          ("fourstep_pass", 1, ND_WIDE, False)],
         lambda a: torch.fft.fftn(c64(a)), lambda a: a,
         bound(ND_WIDE[0]) + bound(ND_WIDE[1]), lambda: torch.fft.fftn(x),
         "torch.fft.fftn")
    del x
    torch.cuda.empty_cache()

    x = (torch.rand((b3 * n2, n2), generator=gen, device="cuda")
         - 0.5).reshape(b3, n2, n2)
    half_bytes = 4.0 * pts + 8.0 * bins
    path(f"rfft2 {tuple(x.shape)} float32", lambda: T.rfft2(x),
         {"r2c": 1, "c2c": 1}, x, half_bytes,
         [("r2c", b3 * n2, n2, None), ("c2c", b3 * (n2 // 2 + 1), n2, False)],
         lambda a: torch.fft.rfft2(a.double()), first, lim,
         lambda: torch.fft.rfft2(x), "torch.fft.rfft2")
    spec = T.rfft2(x)
    expected["r2c"] += 1
    expected["c2c"] += 1
    path(f"irfft2 {tuple(spec.shape)} complex64", lambda: T.irfft2(spec),
         {"c2c": 1, "c2r": 1}, spec, half_bytes,
         [("c2c", b3 * (n2 // 2 + 1), n2, True), ("c2r", b3 * n2, n2, None)],
         lambda a: torch.fft.irfft2(c64(a)), first, lim,
         lambda: torch.fft.irfft2(spec), "torch.fft.irfft2")
    del spec
    path(f"dctn type 2 axes (-2, -1) {tuple(x.shape)} float32",
         lambda: T.dctn(x, axes=(-2, -1)), {"r2c": 2}, x, 8.0 * pts,
         [("r2c", b3 * n2, n2, None)] * 2,
         sp("dctn", axes=(-2, -1)), first, lim,
         composition=lambda: TD.dctn(x, axes=(-2, -1)))
    del x
    torch.cuda.empty_cache()

    nv = ND_CUBE
    x = (torch.rand((nv * nv, nv), generator=gen, device="cuda")
         - 0.5).reshape(nv, nv, nv)
    cube_bins = nv * nv * (nv // 2 + 1)
    path(f"rfftn {tuple(x.shape)} float32", lambda: T.rfftn(x),
         {"r2c": 1, "c2c": 2}, x, 4.0 * x.numel() + 8.0 * cube_bins,
         [("r2c", nv * nv, nv, None)]
         + [("c2c", nv * (nv // 2 + 1), nv, False)] * 2,
         lambda a: torch.fft.rfftn(a.double()), lambda a: a,
         3 * bound(nv), lambda: torch.fft.rfftn(x), "torch.fft.rfftn")
    del x
    torch.cuda.empty_cache()

    # rows of n = 1024 real samples (hfft / ihfft, DCT / DST types 2, 3)
    n = 1024
    b = ND_ROWS
    lim = bound(n)
    row_bytes = 4.0 * b * n + 8.0 * b * (n // 2 + 1)
    h = rand_complex(b, n // 2 + 1, gen)
    path(f"hfft n={n}, {b} rows", lambda: T.hfft(h), {"c2r": 1}, h,
         row_bytes, [("c2r", b, n, None)], lambda a: torch.fft.hfft(c64(a)),
         rows64, lim, lambda: torch.fft.hfft(h), "torch.fft.hfft")
    del h
    x = torch.rand((b, n), generator=gen, device="cuda") - 0.5
    path(f"ihfft n={n}, {b} rows", lambda: T.ihfft(x), {"r2c": 1}, x,
         row_bytes, [("r2c", b, n, None)],
         lambda a: torch.fft.ihfft(a.double()), rows64, lim,
         lambda: torch.fft.ihfft(x), "torch.fft.ihfft")
    for name, t, kernel in (("dct", 2, "r2c"), ("idct", 2, "c2r"),
                            ("dst", 2, "r2c")):
        path(f"{name} type {t} {tuple(x.shape)} float32",
             lambda: getattr(T, name)(x, type=t), {kernel: 1}, x,
             8.0 * x.numel(), [(kernel, b, n, None)], sp(name, type=t),
             rows64, lim, composition=lambda: getattr(TD, name)(x, type=t))
    del x
    torch.cuda.empty_cache()
    x = torch.rand((b, n + 1), generator=gen, device="cuda") - 0.5
    path(f"dct type 1 {tuple(x.shape)} float32", lambda: T.dct(x, type=1),
         {"r2c": 1}, x, 8.0 * x.numel(), [("r2c", b, 2 * n, None)],
         sp("dct", type=1), rows64, bound(2 * n),
         composition=lambda: TD.dct(x, type=1))
    del x
    torch.cuda.empty_cache()
    x = torch.rand(ND_DCT4, generator=gen, device="cuda") - 0.5
    m4 = 2 * ND_DCT4[1]
    path(f"dct type 4 {ND_DCT4} float32", lambda: T.dct(x, type=4),
         {"c2c": 1}, x, 8.0 * x.numel(), [("c2c", ND_DCT4[0], m4, False)],
         sp("dct", type=4), rows64, bound(m4),
         composition=lambda: TD.dct(x, type=4))
    del x
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, expected, worst


def kernels_alone(rows: list) -> None:
    """Each composed row's kernels timed alone on the shapes the path
    gives them (one launch through the wrapper a CUDA-event window, median
    of REPS_CONV, each distinct shape once), summed into the row as
    kernels_ms; ms - kernels_ms is what the torch copies around them
    (transposes, flips, twiddle products) cost.  Runs after the path's
    counters are read."""
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.ops import real as R
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    alone = {}
    for row in rows:
        total = 0.0
        for kernel, b, n, inverse in row["kernels"]:
            key = (kernel, b, n, inverse)
            if key not in alone:
                if kernel == "fourstep_pass":
                    # the column route over an axis (m, k): its passes
                    m, k = n
                    z = rand_complex(b, m * k, gen)
                    alone[key] = cuda_ms(lambda: FF.run_columns(
                        z, m, k, inverse=inverse, scale=1.0 / m if inverse
                        else 1.0), reps=REPS_CONV)
                elif kernel == "c2c":
                    z = rand_complex(b, n, gen)
                    alone[key] = cuda_ms(lambda: C.launch(
                        z, inverse=inverse, scale=1.0 / n if inverse
                        else None), reps=REPS_CONV)
                elif kernel == "r2c":
                    z = torch.rand((b, n), generator=gen, device="cuda")
                    alone[key] = cuda_ms(lambda: R.launch_r2c(z, "numpy"),
                                         reps=REPS_CONV)
                else:
                    z = rand_complex(b, n // 2 + 1, gen)
                    alone[key] = cuda_ms(lambda: R.launch_c2r(
                        z, n=n, layout="numpy", scale=2.0 / n),
                        reps=REPS_CONV)
                del z
                torch.cuda.empty_cache()
            total += alone[key]
        row["kernels_ms"] = total
        row["kernels"] = [list(k) for k in row["kernels"]]
        print(f"  {row['what']}: kernels alone {total:.4f} ms of "
              f"{row['ms']:.4f}; the torch copies around them "
              f"{row['ms'] - total:.4f} ms")


def phase_column_route(card: str) -> dict:
    """The 2-D path's column route at the imaging cell's size: a 16384^2
    complex64 grid (2^28 points), each of its two column passes as the
    two launches run them (radix 128: pass A in place over columns of
    stride 2^21 with the twiddle, pass B from stride 2^14 to 2^21) and the
    row kernel timed alone (median of REPS_CONV CUDA-event runs) beside
    one sweep's floor (the grid read and written once over the card's
    memory rate, 1.282 ms at 3.35 TB/s); the whole ``fft2`` (the row
    kernel and the fused column launch) beside ``torch.fft.fft2`` (the
    yardstick; the port never calls it) and against it in float64 on the
    whole grid.  Alone:
        python3 -c "import chip_smoke as c; n, card = c.phase_card();
                    c.phase_column_route(card)"
    """
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import c2c as C
    from smfft_tpu_torch.ops import fourstep_fused as FF
    from smfft_tpu_torch.parallel import dryrun
    m = 16384
    n = m * m
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = rand_complex(m, m, gen)
    floor_ms = least_ms(16.0 * n, 0.0)[0]
    pa, pb = FF.column_plan(m, m, exact=True)   # the two launches' passes
    buf = x.reshape(1, n).clone()
    out = torch.empty_like(buf)
    ms_a = cuda_ms(lambda: FF.launch_pass(buf, buf, n, pa, at=(1, 2, "col")),
                   reps=REPS_CONV)
    ms_b = cuda_ms(lambda: FF.launch_pass(buf, out, n, pb, at=(2, 2, "col")),
                   reps=REPS_CONV)
    ms_row = cuda_ms(lambda: C.launch(x), reps=REPS_CONV)
    del buf, out
    torch.cuda.empty_cache()
    c0, b0 = counts(), dryrun.copied_bytes()
    y = T.fft2(x)
    torch.cuda.synchronize()
    launched = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
    copied = dryrun.copied_bytes() - b0
    want = torch.fft.fft2(x.to(torch.complex128))
    err = max_err(y, want) / want.abs().max().item()
    del y, want
    torch.cuda.empty_cache()
    ms_fft2 = cuda_ms(lambda: T.fft2(x), reps=REPS_CONV)
    ms_lib = cuda_ms(lambda: torch.fft.fft2(x), reps=REPS_CONV)
    row = {"card": card, "grid": [m, m], "floor_ms": floor_ms,
           "pass_a_ms": ms_a, "pass_b_ms": ms_b, "c2c_ms": ms_row,
           "fft2_ms": ms_fft2, "torch_fft2_ms": ms_lib,
           "launches": launched, "copied_bytes": copied, "rel_err": err}
    print(f"column route {m}^2 ({card}): pass A (radix {pa.radix}, stride "
          f"2^{(m // pa.radix * m).bit_length() - 1}, twiddle, in place) "
          f"{ms_a:.4f} ms, pass B (radix {pb.radix}) {ms_b:.4f} ms, one "
          f"sweep's floor {floor_ms:.4f} ms (at {floor_ms / ms_a:.3f} / "
          f"{floor_ms / ms_b:.3f}); c2c_kernel<{m}> alone {ms_row:.4f} ms; "
          f"fft2 {ms_fft2:.4f} ms ({launched}, {copied} bytes copied), "
          f"torch.fft.fft2 {ms_lib:.4f} ms; relative error {err:.3e}")
    print("column route row: " + json.dumps(row))
    if launched != {"c2c": 1, "fourstep_pass": 1} or copied:
        fail("fft2 of the grid did not run one row launch and the fused "
             "column launch without a copy")
    if not err <= 2 * bound(m):
        fail(f"fft2 of the grid: error {err:.3e} over the bound")
    del x
    torch.cuda.empty_cache()
    return row


def phase_fused_columns(card: str) -> dict:
    """The fused column launch at 2^28 points: the column route over the
    leading axis of the imaging cell's 16384^2 grid (radix 128 carrying
    radix 128, the intermediate handed through L2 a slab of 32 columns at
    a time), in both directions: its result against the two launches' bit
    for bit, its time (median of REPS_CONV CUDA-event runs of the launch
    alone, in place) beside one sweep's floor (``bound_ms``) and the two
    launches' time, the launches of one ``run_columns`` call, and the
    pass-B items a launch that found their slab unfinished
    (``column_waits``).  Alone:
        python3 -c "import chip_smoke as c; n, card = c.phase_card();
                    c.phase_fused_columns(card)"
    """
    from smfft_tpu_torch.ops import fourstep_fused as FF
    m = 16384
    n = m * m
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    x = rand_complex(1, n, gen)
    bound_ms = least_ms(16.0 * n, 0.0)[0]
    (fused,) = FF.column_plan(m, m)
    two = FF.column_plan(m, m, exact=True)
    row = {"card": card, "grid": [m, m], "bound_ms": bound_ms}
    for inverse in (False, True):
        scale = 1.0 / m if inverse else 1.0
        c0, f0 = counts()["fourstep_pass"], FF.run_columns.fused
        got = FF.run_columns(x, m, m, inverse=inverse, scale=scale)
        torch.cuda.synchronize()
        launches = counts()["fourstep_pass"] - c0
        if launches != 1 or FF.run_columns.fused - f0 != 1:
            fail(f"the column route at {m}^2 made {launches} launches, "
                 "not the fused one")
        want = FF.run_passes(x, n, two, inverse=inverse, scale=scale,
                             axis="col")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"the fused column launch differs from the two launches "
                 f"(inverse={inverse}): {max_err(got, want):.3e}")
        del got, want
        torch.cuda.empty_cache()
        buf, out = x.clone(), torch.empty_like(x)
        w0 = FF.column_waits()
        ms = cuda_ms(lambda: FF.launch_pass(
            buf, out, n, fused, inverse=inverse, scale=scale,
            at=(1, 2, "col"), mid=buf), reps=REPS_CONV)
        waits = (FF.column_waits() - w0) / (REPS_CONV + 1)
        ms_two = cuda_ms(lambda: [FF.launch_pass(
            buf, buf, n, two[0], inverse=inverse, scale=scale),
            FF.launch_pass(buf, out, n, two[1], inverse=inverse)],
            reps=REPS_CONV)
        del buf, out
        torch.cuda.empty_cache()
        key = "inverse" if inverse else "forward"
        row[key] = {"ms": ms, "two_launches_ms": ms_two,
                    "launches": launches, "waits": waits}
        print(f"fused column launch {m}^2 {key} ({card}): {ms:.4f} ms, one "
              f"sweep's bound {bound_ms:.4f} ms (at {bound_ms / ms:.3f}), "
              f"the two launches {ms_two:.4f} ms; {launches} launch a call;"
              f" {waits:.0f} of {n // 4096} pass-B items a launch "
              "found their slab unfinished")
    print("fused column row: " + json.dumps(row))
    del x
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phases 19-20: parallel/ (batch sharding and the distributed four-step)
# over torch.distributed: (a) a world of one rank under NCCL in this
# process; (b) PAR_GLOO gloo ranks spawned on this one card (NCCL takes
# one rank a card), the data moved between the processes by gloo
# ---------------------------------------------------------------------------

PAR_GLOO = 4
PAR_SHARDED = (1024, 16384)
PAR_DIST = (1 << 15, 1 << 20, 1 << 24)
PAR_REAL = (1 << 16, 1 << 24)
PAR_GLOO_SIZES = (1 << 20, 1 << 24)
PAR_TIERS = ("highest", "exact")
# phase 20's shapes, 2^27 points or samples a call: rows of 1024, one
# vector (16384 x 8192), 2^28 real samples, the matched filter's streams
PAR_ROWS = 131072
PAR_BIG = 1 << 27
MF_STREAMS, MF_LEN, MF_TEMPLATES, MF_K = 16384, 8192, 8, 256


@contextlib.contextmanager
def nccl_world():
    """A process group of one rank under NCCL in this process (tcp
    rendezvous on a free localhost port), destroyed on the way out."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=600))
    try:
        yield
    finally:
        dist.destroy_process_group()


def par_lim(n: int, k: int = 0, norm: bool = False) -> float:
    """PERF.md §2's bar for an output of k + 1 chained transforms of
    length n on data in [-0.5, 0.5): bound(n) for one transform,
    2 bound(n) sqrt(k + 1) for a chain; a chain that ends in a normalised
    inverse (each step a unitary F / sqrt(n)) divides by sqrt(n), a lone
    normalised inverse by n (as fft_large's check)."""
    lim = bound(n) if k == 0 else 2 * bound(n) * math.sqrt(k + 1)
    if norm:
        lim /= math.sqrt(n) if k else n
    return lim


def full(y) -> torch.Tensor:
    """A DTensor gathered whole (a plain tensor as it is)."""
    from smfft_tpu_torch.parallel.sharding import _full
    from torch.distributed.tensor import DTensor
    return _full(y) if isinstance(y, DTensor) else y


def c_layout(v: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """X (..., N) -> the C-matrix C[k1, k2] = X[k2*n1 + k1]."""
    return v.reshape(v.shape[:-1] + (n2, n1)).transpose(-1, -2)


def times_block(c, h: torch.Tensor):
    """A k1-sharded C-matrix DTensor times the global h, block by block."""
    from smfft_tpu_torch.parallel.sharding import _block, _sharded
    dim = c.placements[0].dim
    return _sharded(c.to_local() * _block(h, c.device_mesh, "fft", dim),
                    c.device_mesh, c.placements[0])


def unpack(h: torch.Tensor) -> torch.Tensor:
    """Packed half-spectrum (slot 0 = DC + i*Nyq) -> numpy rfft layout."""
    return torch.cat([h[..., :1].real.to(h.dtype), h[..., 1:],
                      h[..., :1].imag.to(h.dtype)], dim=-1)


def par_check(what: str, fn, oracle_fn, lim: float, head, prec: str,
              plain=None, plain_fn=None) -> tuple:
    """One parallel call: the output gathered whole, against the same call
    (or ``plain_fn``) under plain_on_card(), or ``plain``, on every element
    and against the
    float64 oracle on ``head`` of it, max abs error within lim; the
    "exact" tier's ulp(max|X|) from float64 printed.  Returns (output,
    error against the plain version)."""
    out = full(fn())
    torch.cuda.synchronize()
    if not bool(torch.isfinite(torch.view_as_real(out) if out.is_complex()
                               else out).all()):
        fail(f"{what}: non-finite output")
    if plain is None:
        with plain_on_card():
            plain = full((plain_fn or fn)())
    err = check_all(out if out.dim() > 1 else out[None],
                    plain if plain.dim() > 1 else plain[None], 0, what,
                    lim=lim)
    del plain
    want = oracle_fn()
    got = head(out)
    if got.shape != want.shape:
        fail(f"{what}: {tuple(got.shape)} against the oracle's "
             f"{tuple(want.shape)}")
    e64 = max_err(got, want)
    note = (f", {e64 / ulp(want.abs().max().item()):.2f} ulp(max|X|)"
            if prec == "exact" else "")
    print(f"  {what}: the first rows vs float64 {e64:.3e} (bound "
          f"{lim:.3e}){note}")
    if not e64 <= lim:
        fail(f"{what}: error against float64 over the bound")
    return out, err


def phase_parallel_sweep():
    """Phase 19 (a): every public name of parallel/ in a world of one
    under NCCL, both tiers, against its plain version on every element and
    float64 torch.fft on the first rows.  Returns the worst error against
    the plain versions."""
    from smfft_tpu_torch import parallel as P
    from smfft_tpu_torch.parallel import sharding as PS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    mesh = P.batch_mesh()
    fmesh = P.batch_mesh(axis_name="fft")
    worst, count = 0.0, 0
    c128 = lambda a: a.to(torch.complex128)  # noqa: E731
    rows64 = lambda a: a[:ORACLE_ROWS]  # noqa: E731
    first = lambda a: a[:4]  # noqa: E731

    def run(what, fn, oracle_fn, lim, head, prec):
        nonlocal worst, count
        out, e = par_check(what, fn, oracle_fn, lim, head, prec)
        worst = max(worst, e)
        count += 1
        return out

    for prec in PAR_TIERS:
        for n in PAR_SHARDED:
            x = rand_complex(SWEEP_POINTS // n, n, gen)
            for inv in (False, True):
                run(f"sharded_fft N={n} inverse={inv} {prec}",
                    lambda: P.sharded_fft(x, mesh, inverse=inv,
                                          precision=prec),
                    lambda: oracle(x[:ORACLE_ROWS], inv) / (n if inv else 1),
                    par_lim(n, norm=inv), rows64, prec)
            h = rand_complex(M_BANK, n, gen)
            run(f"sharded_convolve N={n} bank {M_BANK} {prec}",
                lambda: P.sharded_convolve(x, h, mesh, precision=prec),
                lambda: torch.fft.ifft(torch.fft.fft(c128(x[:ORACLE_ROWS]))
                                       [None] * c128(h)[:, None]),
                par_lim(n, 1, True), lambda a: a[:, :ORACLE_ROWS], prec)
            del x, h
            xr = torch.rand((SWEEP_POINTS // n, n), generator=gen,
                            device="cuda") - 0.5
            spec = run(f"sharded_rfft n={n} {prec}",
                       lambda: PS.sharded_rfft(xr, mesh, precision=prec),
                       lambda: torch.fft.rfft(xr[:ORACLE_ROWS].double()),
                       par_lim(n), rows64, prec)
            run(f"sharded_irfft n={n} {prec}",
                lambda: PS.sharded_irfft(spec, mesh, n, precision=prec),
                lambda: xr[:ORACLE_ROWS].double(), par_lim(n, 1, True),
                rows64, prec)
            del xr, spec
        for n in PAR_DIST:
            b = max(1, SWEEP_POINTS // n)
            e = n.bit_length() - 1
            x = rand_complex(b, n, gen)
            n1, n2 = P.plan_distributed(n, 1)
            want = torch.fft.fft(c128(x[:4]))
            run(f"distributed_fft N=2^{e} ({b} rows) {prec}",
                lambda: P.distributed_fft(x, fmesh, precision=prec),
                lambda: want, par_lim(n), first, prec)
            c = run(f"distributed_fft transposed N=2^{e} {prec}",
                    lambda: P.distributed_fft(x, fmesh, precision=prec,
                                              transposed_output=True),
                    lambda: c_layout(want, n1, n2), par_lim(n), first, prec)
            run(f"distributed_ifft N=2^{e} {prec}",
                lambda: P.distributed_ifft(x, fmesh, precision=prec),
                lambda: torch.fft.ifft(c128(x[:4])), par_lim(n, norm=True),
                first, prec)
            hf = rand_complex(1, n, gen)[0]
            h_c = c_layout(hf, n1, n2).contiguous()
            cd = P.distributed_fft(x, fmesh, precision=prec,
                                   transposed_output=True)
            run(f"distributed_ifft of the C-layout product N=2^{e} {prec}",
                lambda: P.distributed_ifft(times_block(cd, h_c), fmesh,
                                           precision=prec,
                                           transposed_input=True),
                lambda: torch.fft.ifft(want * c128(hf)),
                par_lim(n, 1, True), first, prec)
            del x, c, cd, hf, h_c, want
        for n in PAR_REAL:
            b = max(1, SWEEP_POINTS // n)
            e = n.bit_length() - 1
            xr = torch.rand((b, n), generator=gen, device="cuda") - 0.5
            hp = run(f"distributed_rfft n=2^{e} ({b} rows) {prec}",
                     lambda: P.distributed_rfft(xr, fmesh, precision=prec),
                     lambda: torch.fft.rfft(xr[:4].double()), par_lim(n),
                     lambda a: unpack(a[:4]), prec)
            run(f"distributed_irfft n=2^{e} {prec}",
                lambda: P.distributed_irfft(hp, fmesh, precision=prec),
                lambda: xr[:4].double(), par_lim(n, 1, True), first, prec)
            del xr, hp
        torch.cuda.empty_cache()
    print(f"parallel sweep (a world of one under NCCL): {count} calls, "
          f"worst error against the plain versions {worst:.3e}")
    return worst


def gloo_calls() -> tuple:
    """Phase 19 (b)'s calls for the spawned gloo ranks (inputs made in
    each rank from a seed) and the launches each rank should make."""
    from smfft_tpu_torch.parallel import plan_distributed
    calls, per_rank = [], {"c2c": 0, "conv": 0}
    calls.append(dict(key="sharded_fft", fn="sharded_fft", axis="batch",
                      args=[("rand", (4096, 1024), "complex64", 1), "MESH"]))
    calls.append(dict(key="sharded_convolve", fn="sharded_convolve",
                      axis="batch",
                      args=[("rand", (4096, 1024), "complex64", 1),
                            ("rand", (M_BANK, 1024), "complex64", 2),
                            "MESH"]))
    per_rank["c2c"] += 1
    per_rank["conv"] += 1
    for n in PAR_GLOO_SIZES:
        e = n.bit_length() - 1
        n1, n2 = plan_distributed(n, PAR_GLOO)
        vec = ("rand", (n,), "complex64", e)
        calls += [
            dict(key=f"fft{e}", fn="distributed_fft", args=[vec, "MESH"]),
            dict(key=f"fftT{e}", fn="distributed_fft", args=[vec, "MESH"],
                 kwargs={"transposed_output": True}),
            dict(key=f"filt{e}", fn="distributed_ifft",
                 args=[("refmul", f"fftT{e}",
                        ("rand", (n1, n2), "complex64", e + 50)), "MESH"],
                 kwargs={"transposed_input": True}),
            dict(key=f"back{e}", fn="distributed_ifft",
                 args=[("ref", f"fft{e}"), "MESH"]),
            dict(key=f"rfft{e}", fn="distributed_rfft",
                 args=[("rand", (2, n), "float32", e + 100), "MESH"]),
            dict(key=f"irfft{e}", fn="distributed_irfft",
                 args=[("ref", f"rfft{e}"), "MESH"])]
        per_rank["c2c"] += 6 * 2
    calls.append(dict(key="fft20_exact", fn="distributed_fft",
                      args=[("rand", (1 << 20,), "complex64", 20), "MESH"],
                      kwargs={"precision": "exact"}))
    calls.append(dict(key="timed24", fn="distributed_fft", time=True,
                      gather=False, keep=False,
                      args=[("rand", (1 << 24,), "complex64", 24), "MESH"]))
    per_rank["c2c"] += 2 * 2
    return calls, per_rank


def phase_parallel_gloo(card: str):
    """Phase 19 (b), with phase 20's gloo row: PAR_GLOO ranks spawned
    under gloo, every rank's shards on this card, run gloo_calls(); each
    output against float64 (made here from the same seeds) and against
    the same call's plain version in the world of one (the four-step's
    factors do not depend on the mesh size, so the plain version is the
    same function).  Returns (the launches summed over the ranks and the
    expected ones, the gloo-loopback row, worst error against the plain
    versions)."""
    from smfft_tpu_torch import parallel as P
    from smfft_tpu_torch.parallel.dryrun import rand_input, run_calls, \
        spawn_world
    calls, per_rank = gloo_calls()
    t0 = time.perf_counter()
    ranks = spawn_world(PAR_GLOO, run_calls, (calls, "cuda", REPS_CONV),
                        device="cuda", timeout=900)
    print(f"gloo world of {PAR_GLOO} ranks on one card: "
          f"{time.perf_counter() - t0:.1f} s")
    got = ranks[0]["calls"]
    summed = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]
              ["counts"]}
    expected = {k: v * PAR_GLOO for k, v in per_rank.items()}
    for r in ranks:
        for key, rec in r["calls"].items():
            if "placements" in rec and rec["mesh_size"] != PAR_GLOO:
                fail(f"gloo {key}: mesh of {rec['mesh_size']} ranks")
            if rec.get("local_device") not in (None, "cuda"):
                fail(f"gloo {key}: shards on {rec['local_device']}")

    def cu(spec):
        return torch.from_numpy(rand_input(*spec[1:])).cuda()

    fmesh = P.batch_mesh(axis_name="fft")
    mesh = P.batch_mesh()
    c128 = lambda a: a.to(torch.complex128)  # noqa: E731
    worst = 0.0

    def check(key, plain_fn, oracle_fn, lim, head=lambda a: a):
        nonlocal worst
        out = torch.from_numpy(got[key]["full"]).cuda()
        with plain_on_card():
            plain = full(plain_fn())
        _, e = par_check(f"gloo x{PAR_GLOO} {key}", lambda: out, oracle_fn,
                         lim, head, "highest", plain=plain)
        worst = max(worst, e)

    x = cu(calls[0]["args"][0])
    check("sharded_fft", lambda: P.sharded_fft(x, mesh),
          lambda: oracle(x[:ORACLE_ROWS], False), par_lim(1024),
          lambda a: a[:ORACLE_ROWS])
    h = cu(calls[1]["args"][1])
    check("sharded_convolve", lambda: P.sharded_convolve(x, h, mesh),
          lambda: torch.fft.ifft(torch.fft.fft(c128(x[:ORACLE_ROWS]))[None]
                                 * c128(h)[:, None]),
          par_lim(1024, 1, True), lambda a: a[:, :ORACLE_ROWS])
    del x, h
    for n in PAR_GLOO_SIZES:
        e = n.bit_length() - 1
        n1, n2 = P.plan_distributed(n, PAR_GLOO)
        v = cu(("rand", (n,), "complex64", e))
        want = torch.fft.fft(c128(v))
        check(f"fft{e}", lambda: P.distributed_fft(v, fmesh), lambda: want,
              par_lim(n))
        check(f"fftT{e}", lambda: P.distributed_fft(
            v, fmesh, transposed_output=True),
            lambda: c_layout(want, n1, n2), par_lim(n))
        h_c = cu(("rand", (n1, n2), "complex64", e + 50))
        hf = h_c.transpose(0, 1).reshape(-1)
        check(f"filt{e}", lambda: P.distributed_ifft(
            P.distributed_fft(v, fmesh, transposed_output=True).to_local()
            * h_c, fmesh, transposed_input=True),
            lambda: torch.fft.ifft(want * c128(hf)), par_lim(n, 1, True))
        check(f"back{e}", lambda: P.distributed_ifft(
            P.distributed_fft(v, fmesh), fmesh), lambda: c128(v),
            par_lim(n, 1, True))
        del v, want, h_c, hf
        xr = cu(("rand", (2, n), "float32", e + 100))
        check(f"rfft{e}", lambda: P.distributed_rfft(xr, fmesh),
              lambda: torch.fft.rfft(xr.double()), par_lim(n), unpack)
        check(f"irfft{e}", lambda: P.distributed_irfft(
            P.distributed_rfft(xr, fmesh), fmesh), lambda: xr.double(),
            par_lim(n, 1, True))
        del xr
        torch.cuda.empty_cache()
    v = cu(("rand", (1 << 20,), "complex64", 20))
    check("fft20_exact", lambda: P.distributed_fft(v, fmesh,
                                                   precision="exact"),
          lambda: torch.fft.fft(c128(v)), par_lim(1 << 20))
    del v
    v = cu(("rand", (1 << 24,), "complex64", 24))
    ms_one = cuda_ms(lambda: P.distributed_fft(v, fmesh), reps=REPS_CONV)
    del v
    torch.cuda.empty_cache()
    row = {"what": f"distributed_fft N=2^24, {PAR_GLOO} gloo ranks on one "
           "card (gloo loopback)", "ms": got["timed24"]["ms"],
           "world_of_one_ms": ms_one, "launches_per_rank": {"c2c": 2}}
    print(f"{row['what']} ({card}): {row['ms']:.4f} ms (rank 0, median of "
          f"{REPS_CONV}) | the same call in the world of one (NCCL) "
          f"{ms_one:.4f} ms")
    print(f"gloo world: {len(calls)} calls, worst error against the plain "
          f"versions {worst:.3e}")
    return summed, expected, row, worst


def load_example(name: str):
    """A module of the checkout's examples/ directory."""
    import importlib
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    return importlib.import_module(name)


def phase_main_parallel(card: str):
    """Phase 20: the parallel main path at 2^27 points or samples a call,
    in the world of one under NCCL: sharded_fft of (PAR_ROWS, 1024),
    sharded_convolve with an M_BANK bank at 1024, distributed_fft of one
    2^27 vector, distributed_rfft of 2^28 real samples, and the matched
    filter of MF_STREAMS x MF_LEN samples against MF_TEMPLATES templates.
    Each call once checked (every element against its plain version, the
    first rows against float64) and timed (median of REPS_CONV CUDA-event
    runs) beside a same-run copy_ of its input, the bound (bytes in + out
    over the memory rate) and torch.fft's call or composition.  Returns
    (rows, expected launches, worst error against the plain versions,
    the example's inputs for the references timed after the counters)."""
    import numpy as np
    from smfft_tpu_torch import parallel as P
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    mesh = P.batch_mesh()
    fmesh = P.batch_mesh(axis_name="fft")
    expected = {"c2c": 0, "conv": 0, "conv_real": 0, "r2c": 0}
    rows, worst = [], 0.0
    c128 = lambda a: a.to(torch.complex128)  # noqa: E731
    rows64 = lambda a: a[:ORACLE_ROWS]  # noqa: E731

    def counted(fn, per_call):
        def run():
            for k, v in per_call.items():
                expected[k] += v
            return fn()
        return run

    def path(what, fn, per_call, x, nbytes, oracle_fn, head, lim, library,
             library_name):
        nonlocal worst
        run = counted(fn, per_call)
        _, e = par_check(what, run, oracle_fn, lim, head, "highest",
                         plain_fn=fn)
        worst = max(worst, e)
        torch.cuda.empty_cache()
        ms = cuda_ms(run, reps=REPS_CONV)
        dst = torch.empty_like(x)
        ms_copy = cuda_ms(lambda: dst.copy_(x), reps=REPS_CONV)
        del dst
        with plain_on_card():
            ms_plain = cuda_ms(fn, reps=1)
        ms_lib = cuda_ms(library, reps=REPS_CONV)
        torch.cuda.empty_cache()
        bound_ms = least_ms(nbytes, 0.0)[0]
        rows.append({"what": what, "shape": list(x.shape), "ms": ms,
                     "copy_ms": ms_copy, "bound_ms": bound_ms,
                     "bound_by": "bytes", "plain_ms": ms_plain,
                     "library": library_name, "library_ms": ms_lib,
                     "launches": per_call})
        print(f"{what} ({card}): {ms:.4f} ms | copy_ of the input "
              f"{ms_copy:.4f} ms | bound {bound_ms:.4f} ms, at "
              f"{bound_ms / ms:.3f} | plain {ms_plain:.2f} ms | "
              f"{library_name} {ms_lib:.4f} ms | {ms / ms_lib:.2f}x")

    n = 1024
    x = rand_complex(PAR_ROWS, n, gen)
    path(f"sharded_fft ({PAR_ROWS}, {n}) c64", lambda: P.sharded_fft(x, mesh),
         {"c2c": 1}, x, 16.0 * x.numel(),
         lambda: oracle(x[:ORACLE_ROWS], False), rows64, par_lim(n),
         lambda: torch.fft.fft(x), "torch.fft.fft")
    h = rand_complex(M_BANK, n, gen)
    path(f"sharded_convolve ({PAR_ROWS}, {n}) bank {M_BANK}",
         lambda: P.sharded_convolve(x, h, mesh), {"conv": 1}, x,
         (8.0 + 8.0 * M_BANK) * x.numel(),
         lambda: torch.fft.ifft(torch.fft.fft(c128(x[:ORACLE_ROWS]))[None]
                                * c128(h)[:, None]),
         lambda a: a[:, :ORACLE_ROWS], par_lim(n, 1, True),
         lambda: torch.fft.ifft(torch.fft.fft(x)[None] * h[:, None]),
         "torch.fft composition")
    del x, h
    torch.cuda.empty_cache()
    v = rand_complex(1, PAR_BIG, gen)[0]
    path("distributed_fft N=2^27, one vector (16384 x 8192)",
         lambda: P.distributed_fft(v, fmesh), {"c2c": 2}, v, 16.0 * PAR_BIG,
         lambda: torch.fft.fft(c128(v)),
         lambda a: a, par_lim(PAR_BIG), lambda: torch.fft.fft(v),
         "torch.fft.fft")
    torch.cuda.empty_cache()
    xr = torch.rand(2 * PAR_BIG, generator=gen, device="cuda") - 0.5
    path("distributed_rfft n=2^28, one vector", lambda: P.distributed_rfft(
        xr, fmesh), {"c2c": 2}, xr, 8.0 * xr.numel(),
        lambda: torch.fft.rfft(xr.double()), unpack, par_lim(2 * PAR_BIG),
        lambda: torch.fft.rfft(xr), "torch.fft.rfft")
    del xr
    torch.cuda.empty_cache()

    mf = load_example("matched_filter_torch")
    rng = np.random.default_rng(7)
    bank, truth_tpl, truth_off, xs = mf.simulate(
        MF_STREAMS, MF_LEN, MF_TEMPLATES, MF_K, 0.6, rng)
    xs = torch.from_numpy(xs).cuda()
    hf = mf.filter_bank(bank, MF_LEN, "cuda")
    expected["r2c"] += 1
    scale = xs.abs().max().item() / 0.5
    path(f"matched filter ({MF_STREAMS}, {MF_LEN}) x {MF_TEMPLATES} "
         "templates (convolve_real bank)", lambda: mf.correlate(xs, hf),
         {"conv_real": 1}, xs, (4.0 + 4.0 * MF_TEMPLATES) * xs.numel(),
         lambda: torch.fft.irfft(torch.fft.rfft(xs[:ORACLE_ROWS].double())
                                 [None] * c128(hf)[:, None], n=MF_LEN),
         lambda a: a[:, :ORACLE_ROWS],
         par_lim(MF_LEN, 1, True) * scale,
         lambda: torch.fft.irfft(torch.fft.rfft(xs)[None] * hf[:, None],
                                 n=MF_LEN), "torch.fft composition")
    del xs, hf
    torch.cuda.empty_cache()
    # the whole example at this size, its self-check included
    t0 = time.perf_counter()
    rc = mf.main(["--streams", str(MF_STREAMS), "--length", str(MF_LEN),
                  "--templates", str(MF_TEMPLATES), "--klen", str(MF_K),
                  "--selfcheck"])
    expected["r2c"] += 1
    expected["conv_real"] += 1
    if rc != 0:
        fail("the matched-filter example's self-check failed at 2^27 "
             "samples")
    print(f"examples/matched_filter_torch.py at {MF_STREAMS} x {MF_LEN} "
          f"({card}): {time.perf_counter() - t0:.2f} s end to end "
          "(host simulation included)")
    torch.cuda.synchronize()
    return rows, expected, worst


def parallel_references(rows: list, card: str) -> None:
    """After the counters are read: the port's fft_large of the same 2^27
    vector beside distributed_fft (another kernel, fourstep_pass), and
    distributed_fft's steps timed one by one in the world of one (median
    of REPS_CONV CUDA-event runs each), into the row as ``steps_ms``."""
    import smfft_tpu_torch as T
    from smfft_tpu_torch.ops import fourstep
    from smfft_tpu_torch.parallel import batch_mesh, plan_distributed
    from smfft_tpu_torch.parallel import distributed as D
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    v = rand_complex(1, PAR_BIG, gen)[0]
    ms = cuda_ms(lambda: T.fft_large(v), reps=REPS_CONV)
    row = next(r for r in rows if r["what"].startswith("distributed_fft"))
    row["fft_large_ms"] = ms
    print(f"  api.fft_large of the same 2^27 vector ({card}): {ms:.4f} ms; "
          f"distributed_fft at {row['ms'] / ms:.2f}x")
    fmesh = batch_mesh(axis_name="fft")
    n1, n2 = plan_distributed(PAR_BIG, 1)
    cols = v.reshape(1, n1, n2).transpose(-1, -2)
    rows1 = cols.contiguous()
    b = D._row_fft(rows1, False, "auto", None, None)
    n2_global = torch.arange(n2, device="cuda")
    c = D._all_to_all(b, fmesh, "fft", swap=True)
    out = D._row_fft(c, False, "auto", None, None)
    steps = {
        "stage 1 transposing copy": lambda: cols.contiguous(),
        f"stage 1 c2c (rows of {n1})":
            lambda: D._row_fft(rows1, False, "auto", None, None),
        "twiddle_rows": lambda: fourstep.twiddle_rows(b, n2_global,
                                                      PAR_BIG, False),
        "exchange 1 (two permuting copies and all_to_all_single)":
            lambda: D._all_to_all(b, fmesh, "fft", swap=True),
        f"stage 2 c2c (rows of {n2})":
            lambda: D._row_fft(c, False, "auto", None, None),
        "exchange 2": lambda: D._all_to_all(out, fmesh, "fft", swap=True)}
    row["steps_ms"] = {}
    for what, fn in steps.items():
        row["steps_ms"][what] = cuda_ms(fn, reps=REPS_CONV)
        torch.cuda.empty_cache()
    print(f"  distributed_fft N=2^27 step by step ({card}): "
          + "; ".join(f"{k} {t:.4f} ms" for k, t in row["steps_ms"].items())
          + f"; sum {sum(row['steps_ms'].values()):.4f} of {row['ms']:.4f}")
    del v, cols, rows1, b, c, out
    torch.cuda.empty_cache()


def accel_plain(spec: torch.Tensor, exact: bool) -> torch.Tensor:
    """``accel_plane``'s plain composition on the card (the framing, the
    plain bank, crop and power, as the op runs them on a CPU spectrum),
    a third of the templates at a time, so that the "exact" tier's float64
    bank fits beside the kernel's plane."""
    from smfft_tpu_torch import accel
    k = 2 * accel.half_width(ACCEL_ZMAX) + 1
    h = accel.responses(ACCEL_ZMAX, ACCEL_DZ, accel.choose_nfft(k), exact,
                        spec.device)
    m = h.shape[0]
    out = torch.empty((spec.shape[0], m, spec.shape[1]), device=spec.device)
    step = -(-m // 3)
    with plain_on_card():
        for j in range(0, m, step):
            out[:, j:j + step] = accel._plane(
                spec, h[j:j + step], k, "exact" if exact else None)
            torch.cuda.empty_cache()
    return out


def phase_main_accel(card: str):
    """Phase 21: ``accel_plane`` of ACCEL_ROWS spectra of ACCEL_SAMPLES/2 +
    1 bins at zmax ACCEL_ZMAX in both tiers, each one ``conv_plane``
    launch, against :func:`accel_plain` on the same spectrum: within
    ACCEL_TOL of rms(plain), "exact" also within 8 ulp of max|plain| (the
    plain composition rounds |y| to float32 twice and squares it: 7 ulp at
    most, the kernel half of one).  Then, after the counters are read, the
    call's time beside the plain composition's (the op under
    ``plain_on_card()``, "highest") and the bound.  Returns (row,
    launches, worst max |got - plain|)."""
    from h100bench.work import accel_search as W
    from smfft_tpu_torch import accel
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    bins = ACCEL_SAMPLES // 2 + 1
    spec = rand_complex(ACCEL_ROWS, bins, gen)
    launches, worst = 0, 0.0
    for precision in (None, "exact"):
        reset_counts()
        got = accel.accel_plane(spec, zmax=ACCEL_ZMAX, dz=ACCEL_DZ,
                                precision=precision)
        torch.cuda.synchronize()
        check_counts(f"acceleration plane ({precision or 'highest'})",
                     {"conv_plane": 1})
        launches += 1
        plain = accel_plain(spec, precision == "exact")
        err = rms = top = 0.0
        for i in range(ACCEL_ROWS):
            for j in range(0, plain.shape[1], 67):
                a = got[i, j:j + 67].double()
                b = plain[i, j:j + 67].double()
                err = max(err, (a - b).abs().max().item())
                rms += b.square().sum().item()
                top = max(top, b.max().item())
                del a, b
        rms = math.sqrt(rms / plain.numel())
        del got, plain
        torch.cuda.empty_cache()
        worst = max(worst, err)
        print(f"accel_plane {ACCEL_ROWS} x {bins} bins, zmax {ACCEL_ZMAX}, "
              f"{precision or 'highest'}: max |got - plain| {err:.4e} = "
              f"{err / rms:.3e} rms(plain) (limit {ACCEL_TOL:g}) = "
              f"{err / ulp(top):.2f} ulp(max|plain|)")
        if err > ACCEL_TOL * rms:
            fail(f"accel_plane {precision or 'highest'}: {err / rms:.3e} "
                 f"rms(plain) against the plain composition")
        if precision == "exact" and err > 8 * ulp(top):
            fail(f"accel_plane exact: {err / ulp(top):.2f} ulp(max|plain|) "
                 "against the plain composition")
    ms = cuda_ms(lambda: accel.accel_plane(spec, zmax=ACCEL_ZMAX,
                                           dz=ACCEL_DZ), reps=REPS_CONV)
    torch.cuda.empty_cache()
    with plain_on_card():
        ms_plain = cuda_ms(lambda: accel.accel_plane(
            spec, zmax=ACCEL_ZMAX, dz=ACCEL_DZ), reps=1)
    torch.cuda.empty_cache()
    traffic = {"n": ACCEL_SAMPLES, "rows": ACCEL_ROWS}
    nbytes = W.plane_bytes(traffic)
    bound_ms, bound_by = least_ms(nbytes, W.plane_flops(traffic))
    row = {"what": "accel_plane", "rows": ACCEL_ROWS, "bins": bins,
           "zmax": ACCEL_ZMAX, "ms": ms, "gbs": nbytes / ms / 1e6,
           "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"accel_plane {ACCEL_ROWS} x {bins} bins, zmax {ACCEL_ZMAX} "
          f"({card}): {ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s | bound "
          f"{bound_ms:.4f} ms ({bound_by}), at {bound_ms / ms:.3f} | plain "
          f"composition {ms_plain:.2f} ms")
    return row, launches, worst


def hsum_spectra(rows: int, gen: torch.Generator) -> torch.Tensor:
    """``rfft_large`` of ``rows`` uniform trials of HSUM_SAMPLES samples in
    [-1, 1), as the cell makes its spectra."""
    from smfft_tpu_torch import api
    x = torch.rand((rows, HSUM_SAMPLES), generator=gen, device="cuda")
    return api.rfft_large(x.mul_(2).sub_(1), precision="highest")


def hsum_plain(spec: torch.Tensor, exact: bool, counts: bool) -> tuple:
    """The harmonic sum's plain passes on the card: ``interbin_plain``,
    ``stats_plain`` and ``sum_plain`` of ``ops/harmonic``."""
    from smfft_tpu_torch.ops import harmonic as HS
    q = HS.interbin_plain(spec, exact)
    mu, inv_sigma = HS.stats_plain(q)
    return HS.sum_plain(q, mu, inv_sigma, HSUM_H, counts)


def hsum_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    return ((got.double() - want).abs().max()
            / want.square().mean().sqrt()).item()


def phase_main_harmonic(card: str):
    """Phase 22: the harmonic sum's two kernels through their wrappers on
    HSUM_ROWS spectra of the cell's width, both tiers: one launch each
    (the counts reset just before the pair), the SNR within HSUM_TOL of
    rms(plain) against :func:`hsum_plain` on the same spectrum (the share
    of points whose count is the plain passes' printed beside it); the
    spectrum rounded to bfloat16 outside HSUM_TOL.  Then each kernel alone
    at HSUM_CELL_ROWS trials beside its plain pass and its bound.  Returns
    ({kernel: row}, launches, worst error over rms(plain))."""
    from h100bench.work import periodicity_harmonics as W
    from smfft_tpu_torch.ops import harmonic as HS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    spec = hsum_spectra(HSUM_ROWS, gen)
    bins = spec.shape[1]
    launches, worst = {"interbin": 0, "harmonic_sum": 0}, 0.0
    for exact in (False, True):
        tier = "exact" if exact else "highest"
        reset_counts()
        q, part = HS.launch_interbin(spec, exact=exact)
        snr, count = HS.launch_harmonic_sum(q, part, harmonics=HSUM_H,
                                            counts=True, exact=exact)
        torch.cuda.synchronize()
        got = check_counts(f"harmonic sum ({tier})",
                           {"interbin": 1, "harmonic_sum": 1})
        for k in launches:
            launches[k] += got[k]
        del q, part
        want, want_count = hsum_plain(spec, exact, True)
        err = hsum_err(snr, want)
        same = (count == want_count).double().mean().item()
        del snr, count, want, want_count
        bf = torch.view_as_complex(torch.view_as_real(spec).to(
            torch.bfloat16).float().contiguous())
        q, part = HS.launch_interbin(bf, exact=exact)
        bf_err = hsum_err(HS.launch_harmonic_sum(
            q, part, harmonics=HSUM_H, exact=exact)[0],
            hsum_plain(spec, exact, False)[0])
        del bf, q, part
        torch.cuda.empty_cache()
        worst = max(worst, err)
        print(f"harmonic sum {HSUM_ROWS} x {bins} bins, {HSUM_H} harmonics, "
              f"{tier}: max |snr - plain| {err:.3e} rms(plain) (limit "
              f"{HSUM_TOL:g}); counts equal at {same:.6f} of the points; "
              f"bfloat16 spectrum {bf_err:.3e}")
        if err > HSUM_TOL:
            fail(f"harmonic sum {tier}: {err:.3e} rms(plain) against the "
                 "plain passes")
        if bf_err <= HSUM_TOL:
            fail(f"harmonic sum {tier}: the bfloat16 spectrum reads "
                 f"{bf_err:.3e}, within HSUM_TOL")
    del spec
    torch.cuda.empty_cache()
    spec = hsum_spectra(HSUM_CELL_ROWS, gen)
    traffic = {"n": HSUM_SAMPLES, "rows": HSUM_CELL_ROWS}
    q, part = HS.launch_interbin(spec)
    (snr,) = HS.launch_harmonic_sum(q, part, harmonics=HSUM_H)
    rows = {}
    for name, fn, plain_fn, nbytes, flops in (
            ("interbin", lambda: HS.launch_interbin(spec),
             lambda: HS.interbin_plain(spec),
             spec.nbytes + q.nbytes + part.nbytes,
             8.0 * HSUM_CELL_ROWS * bins),
            ("harmonic_sum",
             lambda: HS.launch_harmonic_sum(q, part, harmonics=HSUM_H),
             lambda: HS.sum_plain(q, *HS.stats_plain(q), HSUM_H),
             q.nbytes + part.nbytes + snr.nbytes,
             4.0 * HSUM_CELL_ROWS * W.terms(traffic))):
        ms = cuda_ms(fn)
        torch.cuda.empty_cache()
        ms_plain = cuda_ms(plain_fn, reps=1)
        torch.cuda.empty_cache()
        bound_ms, bound_by = least_ms(nbytes, flops)
        rows[name] = {"what": name, "rows": HSUM_CELL_ROWS, "bins": bins,
                      "harmonics": HSUM_H, "ms": ms,
                      "gbs": nbytes / ms / 1e6, "plain_ms": ms_plain,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{name} alone, {HSUM_CELL_ROWS} x {bins} bins ({card}): "
              f"{ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s | bound "
              f"{bound_ms:.4f} ms ({bound_by}), at {bound_ms / ms:.3f} | "
              f"plain pass {ms_plain:.2f} ms")
    del spec, q, part, snr
    torch.cuda.empty_cache()
    return rows, launches, worst


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
    c2c_counts = check_counts("C2C", {"c2c": calls})

    reset_counts()
    real_rows, n_r2c, n_c2r, worst_real_main = phase_main_real(card)
    real_counts = check_counts("real", {"r2c": n_r2c, "c2r": n_c2r})
    c2r_kernel_ms = c2r_alone(card)

    from smfft_tpu_torch import verify
    for argv in (["1024", "4096", "2", "0", "1"],
                 ["4096", "4096", "2", "--kind", "r2c"],
                 ["4096", "4096", "2", "--kind", "c2r"]):
        if verify.main(argv) != 0:
            fail(f"verify {' '.join(argv)} did not pass")

    worst_reuse = phase_reuse_sweep()
    reset_counts()
    reuse_rows, reuse_calls, worst_reuse_main = phase_main_reuse(card)
    reuse_counts = check_counts("reuse", reuse_calls)
    reuse_references(reuse_rows, card)

    worst_conv = phase_conv_sweep()
    reset_counts()
    conv_rows, conv_calls, worst_conv_main = phase_main_conv(card)
    conv_counts = check_counts("convolution", conv_calls)

    worst_power = phase_spectral_sweep()
    reset_counts()
    spec_rows, spec_calls, worst_power_main = phase_main_spectral(card)
    spec_counts = check_counts("spectral", {"power": spec_calls})
    worst_blue, _ = phase_bluestein_sweep()
    reset_counts()
    blue_rows, blue_calls, worst_blue_main = phase_main_bluestein(card)
    blue_counts = check_counts("Bluestein", {"bluestein": blue_calls})
    worst_huge, _, plan_table = phase_huge_sweep(card)
    reset_counts()
    huge_rows, huge_calls, worst_huge_main = phase_main_huge(card)
    huge_counts = check_counts("huge-N", huge_calls)
    split_row = real_huge_alone(card)
    phase_fused_tail(card)
    worst_nd = phase_ndim_sweep()
    reset_counts()
    nd_rows, nd_calls, worst_nd_main = phase_main_ndim(card)
    nd_counts = check_counts("ndim / DCT", nd_calls)
    kernels_alone(nd_rows)
    print(f"ndim / DCT: worst relative error against the plain versions "
          f"{max(worst_nd, worst_nd_main):.3e}")
    phase_column_route(card)
    phase_fused_columns(card)
    with nccl_world():
        worst_par = phase_parallel_sweep()
        reset_counts()
        par_rows, par_calls, worst_par_main = phase_main_parallel(card)
        par_counts = check_counts("parallel", par_calls)
        parallel_references(par_rows, card)
        gloo_counts, gloo_calls_expected, gloo_row, worst_gloo = \
            phase_parallel_gloo(card)
    want = {k: gloo_calls_expected.get(k, 0) for k in gloo_counts}
    print(f"launch counters summed over the {PAR_GLOO} gloo ranks: "
          f"{gloo_counts} (expected {want})")
    if gloo_counts != want:
        fail("the gloo ranks did not go through their kernels once per call")
    print(f"parallel: worst error against the plain versions "
          f"{max(worst_par, worst_par_main, worst_gloo):.3e}")
    accel_row, accel_launches, worst_accel = phase_main_accel(card)
    hsum_rows, hsum_launches, worst_hsum = phase_main_harmonic(card)
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
          "torch.fft.irfft; c2r's kernel_ms is the kernel alone (ten "
          "launches of smfft_c2r between two events) on the same shape; "
          "ndim_launches counts the c2c / r2c / c2r launches of the ndim / "
          "DCT main path (phase 18)")
    print("main path rows: " + json.dumps({"card": card, "ndim": nd_rows}))
    kernels = [
        {"name": "c2c", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/c2c.cu",
         "replaces": "smfft_tpu/ops/pallas_c2c.py:1015",
         "launches": c2c_counts["c2c"],
         "max_abs_err": max(worst_c2c, worst_main),
         "ms": main_row["fft_ms"], "plain_ms": main_row["plain_ms"],
         "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
         "library_ms": main_row["torch_fft_ms"],
         "ndim_launches": nd_counts["c2c"]},
        {"name": "r2c", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/real.cu",
         "replaces": "smfft_tpu/ops/pallas_real.py:270",
         "launches": real_counts["r2c"],
         "max_abs_err": max(worst_real["r2c"], worst_real_main["r2c"]),
         "ms": real_row["planar_rfft_ms"],
         "plain_ms": real_row["plain_r2c_ms"],
         "bound_ms": real_row["bound_ms"], "bound_by": real_row["bound_by"],
         "library_ms": real_row["torch_rfft_ms"],
         "ndim_launches": nd_counts["r2c"]},
        {"name": "c2r", "route": "cuda",
         "source": "smfft_tpu_torch/csrc/c2r.cu",
         "replaces": "smfft_tpu/ops/pallas_real.py:544",
         "launches": real_counts["c2r"],
         "max_abs_err": max(worst_real["c2r"], worst_real_main["c2r"]),
         "ms": real_row["planar_irfft_ms"], "kernel_ms": c2r_kernel_ms,
         "plain_ms": real_row["plain_c2r_ms"],
         "bound_ms": real_row["bound_ms"], "bound_by": real_row["bound_by"],
         "library_ms": real_row["torch_irfft_ms"],
         "ndim_launches": nd_counts["c2r"]},
    ]
    mult = {r["form"]: r for r in reuse_rows if r["n"] == 1024}
    conv = {r["what"]: r for r in conv_rows if r["n"] == 1024}
    print("main path rows: " + json.dumps({"card": card,
                                           "reuse": reuse_rows,
                                           "convolution": conv_rows}))
    print("c2c_multiple also replaces smfft_tpu/ops/pencil.py:206 (iters > "
          "1); conv also convolve.py:152 (bank); conv_real also "
          "convolve.py:353 (bank).  c2c_multiple = fft_planar(multiple_iters"
          f"={ITERS}), real_multiple = multiple_real_pencil_planar(iters="
          f"{ITERS}), conv = convolve, conv_real = convolve_real, at N = n "
          "= 1024 with 2^27 points or samples; no single PyTorch call "
          "computes these functions (library_ms null); composition_ms is "
          "the torch.fft three-call composition (fft, multiply, ifft)")
    for kname, row, kernel, src, rep in (
            ("c2c_multiple", mult["fft_planar"], "c2c_multiple",
             "multiple.cu", "pallas_c2c.py:1015"),
            ("real_multiple", mult["real"], "real_multiple", "multiple.cu",
             "pencil.py:466"),
            ("conv", conv["convolve"], "conv", "conv.cu", "convolve.py:67"),
            ("conv_real", conv["convolve_real"], "conv_real", "conv.cu",
             "convolve.py:253")):
        reuse = "multiple" in kname
        worst = (worst_reuse if reuse else worst_conv)[kernel]
        worst_main = (worst_reuse_main if reuse else worst_conv_main)[kernel]
        entry = {"name": kname, "route": "cuda",
                 "source": f"smfft_tpu_torch/csrc/{src}",
                 "replaces": f"smfft_tpu/ops/{rep}",
                 "launches": (reuse_counts if reuse else conv_counts)[kernel],
                 "max_abs_err": max(worst, worst_main),
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": None}
        if "composition_ms" in row:
            entry["composition_ms"] = row["composition_ms"]
        kernels.append(entry)
    print("main path rows: " + json.dumps({"card": card,
                                           "accel": accel_row}))
    print("conv_plane replaces no TPU kernel: accel_plane at zmax 200 of 2 "
          "spectra of 2^22 + 1 bins (the fdas.z200.n2e23 cell's call); "
          "plain_ms is the op's plain composition on the card (framing, "
          "plain bank, crop, power); bound_ms the spectrum read and the "
          "plane written at peak bandwidth")
    kernels.append({"name": "conv_plane", "route": "cuda",
                    "source": "smfft_tpu_torch/csrc/conv.cu",
                    "replaces": None, "launches": accel_launches,
                    "max_abs_err": worst_accel, "ms": accel_row["ms"],
                    "plain_ms": accel_row["plain_ms"],
                    "bound_ms": accel_row["bound_ms"],
                    "bound_by": accel_row["bound_by"], "library_ms": None})
    print("main path rows: " + json.dumps({"card": card,
                                           "harmonic": hsum_rows}))
    print("interbin and harmonic_sum replace no TPU kernel: their ms are "
          f"each launch alone on {HSUM_CELL_ROWS} spectra of 2^22 + 1 bins "
          f"at {HSUM_H} harmonics (the hsum.h32.n2e23 cell's call); "
          "plain_ms is the plain pass on the card; bound_ms the launch's "
          "tensors read or written once at peak bandwidth; launches and "
          f"max_abs_err (over rms(plain)) from the {HSUM_ROWS}-trial "
          "check in both tiers")
    for name, row in hsum_rows.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "smfft_tpu_torch/csrc/periodicity.cu",
                        "replaces": None, "launches": hsum_launches[name],
                        "max_abs_err": worst_hsum, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    print("main path rows: " + json.dumps({"card": card,
                                           "spectral": spec_rows,
                                           "bluestein": blue_rows}))
    power = spec_rows[0]  # power_spectrum at n = 1024
    blue = blue_rows[0]   # fft_any at n = 1000
    print("power = power_spectrum with a hann window at n = 1024, 2^27 "
          "samples (no single PyTorch call computes it: library_ms null; "
          "composition_ms is torch.fft.rfft(x*w).abs().square()); bluestein "
          "= fft_any at n = 1000, 131072 rows, against torch.fft.fft")
    kernels.append({"name": "power", "route": "cuda",
                    "source": "smfft_tpu_torch/csrc/spectral.cu",
                    "replaces": "smfft_tpu/ops/spectral.py:54",
                    "launches": spec_counts["power"],
                    "max_abs_err": max(worst_power, worst_power_main),
                    "ms": power["ms"], "plain_ms": power["plain_ms"],
                    "bound_ms": power["bound_ms"],
                    "bound_by": power["bound_by"], "library_ms": None,
                    "composition_ms": power["reference_ms"]})
    kernels.append({"name": "bluestein", "route": "cuda",
                    "source": "smfft_tpu_torch/csrc/chirp.cu",
                    "replaces": "smfft_tpu/ops/chirp.py:78",
                    "launches": blue_counts["bluestein"],
                    "max_abs_err": max(worst_blue, worst_blue_main),
                    "ms": blue["ms"], "plain_ms": blue["plain_ms"],
                    "bound_ms": blue["bound_ms"],
                    "bound_by": blue["bound_by"],
                    "library_ms": blue["reference_ms"]})
    print("main path rows: " + json.dumps({"card": card, "huge": huge_rows,
                                           "plan_table": plan_table,
                                           "real_huge_alone": split_row}))
    fs = next(r for r in huge_rows if r["what"].startswith(
        "fft_large N=2^20"))
    print("fourstep_pass also replaces smfft_tpu/ops/hugefft.py:100,137,258,"
          "360 and fourstep_fused.py:113,168 (each plan is launches of it); "
          "its ms, plain_ms, bound_ms and library_ms are fft_large at N = "
          "2^20, 128 rows (two passes) against torch.fft.fft.  real_huge "
          "also replaces real_fused.py:296,409; its numbers are the pair "
          "split alone on 2^27 samples (no PyTorch call computes it: "
          "library_ms null)")
    kernels.append({"name": "fourstep_pass", "route": "cuda",
                    "source": "smfft_tpu_torch/csrc/fourstep.cu",
                    "replaces": "smfft_tpu/ops/rowfour.py:231",
                    "launches": huge_counts["fourstep_pass"],
                    "max_abs_err": max(worst_huge["fourstep_pass"],
                                       worst_huge_main["fourstep_pass"]),
                    "ms": fs["ms"], "plain_ms": fs["plain_ms"],
                    "bound_ms": fs["bound_ms"], "bound_by": fs["bound_by"],
                    "library_ms": fs["reference_ms"]})
    kernels.append({"name": "real_huge", "route": "cuda",
                    "source": "smfft_tpu_torch/csrc/real_huge.cu",
                    "replaces": "smfft_tpu/ops/real_fused.py:146",
                    "launches": huge_counts["real_huge"],
                    "max_abs_err": max(worst_huge["real_huge"],
                                       worst_huge_main["real_huge"]),
                    "ms": split_row["ms"], "plain_ms": split_row["plain_ms"],
                    "bound_ms": split_row["bound_ms"],
                    "bound_by": split_row["bound_by"], "library_ms": None})
    print("main path rows: " + json.dumps({"card": card,
                                           "parallel": par_rows,
                                           "gloo": gloo_row}))
    print("parallel_launches: each kernel's launches on the parallel main "
          "path (phase 20, a world of one under NCCL); gloo_launches: "
          f"summed over the {PAR_GLOO} gloo ranks on this card (phase 19 "
          "(b)); the evidence for more than one rank is gloo on one card, "
          "not NCCL across cards")
    for entry in kernels:
        if entry["name"] in par_counts:
            entry["parallel_launches"] = par_counts[entry["name"]]
            entry["gloo_launches"] = gloo_counts[entry["name"]]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
