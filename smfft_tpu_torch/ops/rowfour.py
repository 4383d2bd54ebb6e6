"""Ordered C2C FFT for N = 2**14..2**17: the four-step N = N1 x 128.

Counterpart of ``smfft_tpu/ops/rowfour.py`` (B17).  The TPU kernel holds a
whole row in VMEM and does the four-step in one pass over device memory:
N1-point lane DFTs, the exact twiddle W_N^(t2 k1), and a 128-point sublane
DFT on the matrix unit.  Here the same decomposition runs as two passes of
``csrc/fourstep.cu`` (ops/fourstep_fused.py), so B17 costs two reads and
two writes of the data on the H100, not one: pass 1 does the N1-point
transforms of the columns of stride 128 with the twiddle and the scale,
pass 2 the 128-point transforms of the rows, stored in natural order.  A
one-pass kernel for these sizes (a 2^17-point complex64 row is 1 MB,
beyond one block's 227 KB of shared memory, so it would span a cluster)
is later work.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch.ops import fourstep_fused as FF

#: N -> (N1, N2): the radices of the two passes, as the JAX package splits
#: these sizes (N2 = 128).
FACTORS = {
    16384: (128, 128),
    32768: (256, 128),
    65536: (512, 128),
    131072: (1024, 128),
}


def fft_rowfour_planar(vr: torch.Tensor, vi: torch.Tensor, *,
                       inverse: bool = False, precision: str = "highest",
                       scale: float = 1.0, multiple_iters: int = 0):
    """Ordered C2C FFT over the last axis, planar fp32 in and out, natural
    order, unnormalized unless ``scale`` (a power of two).  Batched over
    leading axes; any batch (no padding: the kernel masks the tail).

    ``multiple_iters`` = k > 0 applies the transform k times (each with
    ``scale``), as the TPU kernel's in-VMEM loop does; here each
    application is a full two-pass transform through device memory.
    Supported N: keys of :data:`FACTORS`."""
    from smfft_tpu_torch import api
    n = vr.shape[-1]
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    if n not in FACTORS:
        raise ValueError(f"Error wrong FFT length! N={n}; rowfour supports "
                         f"{sorted(FACTORS)}")
    exact = api._exact(precision)
    passes = FF.plan(FACTORS[n])
    out = FF._pair(vr, vi)
    for _ in range(max(1, multiple_iters)):
        out = FF.run_passes(out, n, passes, inverse=inverse, scale=scale,
                            exact=exact)
    return out[0].reshape(vr.shape), out[1].reshape(vi.shape)
