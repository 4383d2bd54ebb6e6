"""Huge-N C2C FFT, N = 2**18..2**28, by plans of two, three or five passes.

Counterpart of ``smfft_tpu/ops/hugefft.py`` (B18-B21).  The TPU's plans
are shaped by VMEM and the matrix unit: a transpose pass P0 to a
(B*128, M) layout (B18), then either a two-pass finisher (B19: M-point
FFT, twiddle, 128-point sublane DFT, "fold" or "revisit" output), or a
row pass with the N-twiddle in its epilogue (B20) and a 128-point
contraction (B21), which with an outer twiddle also closes the five-pass
plan.  On the H100 every plan is p launches of ``csrc/fourstep.cu``
(ops/fourstep_fused.py's :func:`~smfft_tpu_torch.ops.fourstep_fused.plan`),
N split into p radices of 16..2048 points:

  * B18's relayout is the first pass's strided load (columns of stride
    N/R1: no separate transpose pass);
  * B19-B21's finishers are the later passes (the row passes with their
    twiddles, and the last pass, whose store lands natural order);
  * "two:revisit" and "two:fold" are the same two-pass plan (their TPU
    difference is how a VMEM block is written back); "three" is three
    passes; "five" five.

The plan names, their size limits and their errors are the JAX package's;
the default plan table is the port's own (:data:`DEFAULT_TWO_MAX`,
measured on the H100 by ``chip_smoke.py``'s phase 15), not
``hugefft._default_plan``'s TPU breakpoints.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch.ops import fourstep_fused as FF

LANES = 128

#: the two-pass plans' cap (the JAX package's).
TWO_PASS_MAX = 1 << 21

#: the largest N of the huge-N plans.
FIVE_PASS_MAX = 1 << 28

#: passes of each named plan.
PLAN_PASSES = {"two:revisit": 2, "two:fold": 2, "three": 3, "five": 5}

#: the default plan: two passes up to this N, three above (at 2^21 the two
#: passes are 2048 x 1024, and a radix-2048 pass holds one tile buffer).
DEFAULT_TWO_MAX = 1 << 20


def default_plan(n: int) -> str:
    return "two:revisit" if n <= DEFAULT_TWO_MAX else "three"


def check_plan(n: int, plan: str | None) -> str:
    """The plan for N (the default when None), with the JAX package's size
    errors."""
    if n <= 1 << 17 or n > FIVE_PASS_MAX or (n & (n - 1)):
        raise ValueError(
            f"Error wrong FFT length! N={n}; hugefft supports powers of "
            f"two in [2**18, 2**28]")
    plan = plan or default_plan(n)
    if plan not in PLAN_PASSES:
        raise ValueError(f"unknown plan {plan!r}; one of "
                         f"{sorted(PLAN_PASSES)}")
    if plan.startswith("two") and n > TWO_PASS_MAX:
        raise ValueError(f"two-pass plan caps at N={TWO_PASS_MAX}")
    if plan == "five" and n // LANES // LANES < LANES:
        raise ValueError(
            f"five-pass plan needs N >= 2**21 (inner rows of at least "
            f"{LANES}); got N={n}")
    return plan


def passes(n: int, plan: str | None) -> tuple:
    """The launches of a plan at N."""
    plan = check_plan(n, plan)
    return FF.plan(FF.radices(n, PLAN_PASSES[plan]))


def fft_huge_planar(vr: torch.Tensor, vi: torch.Tensor, *,
                    inverse: bool = False, precision: str = "highest",
                    scale: float = 1.0, plan: str | None = None):
    """Huge-N C2C FFT over the last axis, planar fp32 in and out, natural
    order, unnormalized unless ``scale`` (a power of two).  N = 2**18..
    2**28; batched over leading axes.  ``plan`` overrides the default:
    "two:revisit", "two:fold", "three" or "five"."""
    from smfft_tpu_torch import api
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    n = vr.shape[-1]
    ps = passes(n, plan)
    o_r, o_i = FF.run_passes(FF._pair(vr, vi), n, ps, inverse=inverse,
                             scale=scale, exact=api._exact(precision))
    return o_r.reshape(vr.shape), o_i.reshape(vi.shape)
