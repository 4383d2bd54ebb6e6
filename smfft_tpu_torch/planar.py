"""Planar public API — C2C transforms of separate fp32 (re, im) planes.

``(vr, vi)`` float32 (..., N) -> ``(or, oi)`` float32 (..., N), natural
order when ``ordered=True``, revblock otherwise; batched over any leading
shape, with the same size switch, packing rule and normalization contract
as :mod:`smfft_tpu_torch.api`.  The kernel reads and writes the planes
directly, with no conversion pass.

Unlike the JAX package's planar API, N = 32 / 64 work: the planes are
regrouped into 128-wide rows of 128/N transforms before the row-layout op,
so the batch must be a multiple of 128/N.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.ops import c2c as C


def _rows(vr: torch.Tensor, vi: torch.Tensor):
    """(..., n) pair -> ((rows, max(n, 128)) float32 pair, batch_shape)."""
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    n = vr.shape[-1]
    C.check_size(n)
    batch = vr.shape[:-1]
    b = vr.numel() // n
    C.check_pack(b, n)
    row = max(n, C.LANES)
    shape = (b * n // row, row)
    return (vr.to(torch.float32).reshape(shape).contiguous(),
            vi.to(torch.float32).reshape(shape).contiguous(), batch)


def _run(vr, vi, precision, **kw):
    api._resolve_precision(precision)
    n = vr.shape[-1]
    r, i, batch = _rows(vr, vi)
    o_r, o_i = C.fft_planar(r, i, n, **kw)
    return o_r.reshape(batch + (n,)), o_i.reshape(batch + (n,))


def fft(vr: torch.Tensor, vi: torch.Tensor, ordered: bool = True,
        precision: str | None = None):
    """Planar forward C2C FFT over the last axis."""
    return _run(vr, vi, precision, ordered=ordered)


def ifft(vr: torch.Tensor, vi: torch.Tensor, ordered: bool = True,
         precision: str | None = None, norm: str | None = "backward"):
    """Planar inverse C2C FFT; ``norm="backward"`` divides by N (fused
    into the kernel's load), ``norm=None`` is the reference's raw
    inverse."""
    return _run(vr, vi, precision, inverse=True, ordered=ordered,
                scale=api._norm_scale(norm, vr.shape[-1]))


def ifft_unordered(vr: torch.Tensor, vi: torch.Tensor,
                   precision: str | None = None,
                   norm: str | None = "backward"):
    """Planar inverse consuming the revblock layout ``fft(ordered=False)``
    produces, returning natural order."""
    return _run(vr, vi, precision, inverse=True, rev_in=True,
                scale=api._norm_scale(norm, vr.shape[-1]))
