"""Planar public API — transforms of separate fp32 (re, im) planes.

Layout contracts, batched over any leading shape, with the same size
switch, packing rule and normalization contract as
:mod:`smfft_tpu_torch.api`:
  * C2C: ``(vr, vi)`` float32 (..., N) -> ``(or, oi)`` float32 (..., N),
    natural order when ``ordered=True``, revblock otherwise.
  * R2C: real (..., N) -> packed planar pair (..., N/2), slot 0 =
    (DC, Nyquist) (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:
    332-340); natural bin order, or revblock at size N/2.
  * C2R: packed pair (..., N/2), natural or revblock -> real (..., N);
    numpy normalization under ``norm="backward"``, the reference's raw
    (N/2)-scale under ``norm=None``.  N >= 256 for R2C and C2R, as in the
    JAX package.
  * Convolution: ``(vr, vi)`` (..., N) against a natural-order response
    ``(hr, hi)`` (N,) -> ``ifft(fft(x) * H)``, one fused kernel pass.
  * Any length n <= 8192 (``fft_any``): rows (..., n_pad), the signal in
    the first n lanes, n_pad = n rounded up to 128 -> the DFT in the same
    shape, lanes >= n exactly zero (Bluestein, one kernel pass).
  * Huge N (``fft_large`` / ``ifft_large`` to 2^28, ``rfft_large`` /
    ``irfft_large`` from 2^15 to 2^29): the same C2C and packed real
    contracts, natural order, through the multi-pass kernels.
The kernels read and write the planes directly, with no conversion pass.

Unlike the JAX package's planar API, N = 32 / 64 work: the planes are
regrouped into 128-wide rows of 128/N transforms before the row-layout op,
so the batch must be a multiple of 128/N.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import api, bluestein
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import chirp as CH
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.ops import fourstep as FS
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.ops import real_fused as RF
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES


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
    exact = api._exact(precision)
    n = vr.shape[-1]
    r, i, batch = _rows(vr, vi)
    o_r, o_i = C.fft_planar(r, i, n, exact=exact, **kw)
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


def rfft(x: torch.Tensor, ordered: bool = True,
         precision: str | None = None):
    """Planar R2C: real (..., N) -> packed planar pair (..., N/2) with
    slot 0 = (DC, Nyquist); natural bin order when ``ordered=True``,
    revblock otherwise (pairs with :func:`irfft`'s ``in_natural``)."""
    n = x.shape[-1]
    R.check_fused(n, "planar rfft")
    exact = api._exact(precision)
    rows, batch, _ = R.rows_of(x.to(torch.float32), n)
    hr, hi = R.rfft_planar(rows, exact=exact, ordered=ordered)
    return hr.reshape(batch + (n // 2,)), hi.reshape(batch + (n // 2,))


def irfft(vr: torch.Tensor, vi: torch.Tensor, n: int | None = None,
          precision: str | None = None, norm: str | None = "backward",
          in_natural: bool = True):
    """Planar C2R: packed spectrum pair (..., N/2) -> real (..., N).
    ``in_natural=False`` consumes the revblock layout of
    ``rfft(ordered=False)`` relayout-free; the norm's scale is fused into
    the kernel."""
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    n = n or vr.shape[-1] * 2
    R.check_fused(n, "planar irfft")
    if vr.shape[-1] != n // 2:
        raise ValueError(f"n={n} takes {n // 2} bins, got {vr.shape[-1]}")
    exact = api._exact(precision)
    scale = api.real_norm_scale(norm, n)
    r, batch, _ = R.rows_of(vr.to(torch.float32), n // 2)
    i, _, _ = R.rows_of(vi.to(torch.float32), n // 2)
    out = R.irfft_planar(r, i, n, exact=exact, in_natural=in_natural,
                         scale=scale)
    return out.reshape(batch + (n,))


def convolve(vr: torch.Tensor, vi: torch.Tensor, hr: torch.Tensor,
             hi: torch.Tensor, precision: str | None = None):
    """Planar fused circular convolution: ``ifft(fft(x) * H)`` (numpy
    normalization) in one kernel pass.  ``H = (hr, hi)`` is the (N,)
    frequency response in natural order.  Below N = 128 the planes are
    regrouped into 128-wide rows as in :func:`fft`."""
    n = vr.shape[-1]
    exact = api._exact(precision)
    r, i, batch = _rows(vr, vi)
    o_r, o_i = CV.convolve_planar(r, i, hr, hi, n, exact=exact)
    return o_r.reshape(batch + (n,)), o_i.reshape(batch + (n,))


def fft_any(vr: torch.Tensor, vi: torch.Tensor, n: int | None = None,
            precision: str | None = None):
    """Planar arbitrary-length DFT (Bluestein, one pass of
    ``csrc/chirp.cu``): rows are (..., n_pad) with the signal in the first n
    lanes (n_pad = n rounded up to 128); returns the same shape with lanes
    >= n exactly zero.  Pass ``n`` when it is not a multiple of 128."""
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")
    n = n or vr.shape[-1]
    np_ = CH.n_pad(n)
    if np_ != vr.shape[-1]:
        raise ValueError(f"expected padded row width {np_} for n={n}, got "
                         f"{vr.shape[-1]}")
    m = bluestein._conv_length(2 * n - 1)
    batch = vr.shape[:-1]
    o_r, o_i = CH.bluestein_planar(vr.reshape(-1, np_), vi.reshape(-1, np_),
                                   n, m, precision=precision)
    return o_r.reshape(batch + (np_,)), o_i.reshape(batch + (np_,))


def _check_pair(vr: torch.Tensor, vi: torch.Tensor) -> None:
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(vr.shape)} vs "
                         f"{tuple(vi.shape)}")


def fft_large(vr: torch.Tensor, vi: torch.Tensor,
              precision: str | None = None):
    """Planar huge-N forward C2C FFT (N = 2**15..2**28, natural order) with
    no conversion pass: the first pass reads the planes, the last writes
    them.  Row sizes (N <= 16384) route to the row kernel."""
    _check_pair(vr, vi)
    n = vr.shape[-1]
    if n not in SUPPORTED_C2C_SIZES:
        FS.split_factors(n)   # raises the reference-style size error
    return FF.dispatch_planar(vr, vi, precision=precision)


def ifft_large(vr: torch.Tensor, vi: torch.Tensor,
               precision: str | None = None,
               norm: str | None = "backward"):
    """Planar huge-N inverse C2C FFT; ``norm="backward"`` folds the 1/N
    into the first pass, ``norm=None`` is the raw unnormalized inverse."""
    _check_pair(vr, vi)
    if norm not in ("backward", None):
        raise ValueError(f"ifft_large supports norm='backward' or norm=None; "
                         f"got {norm!r}")
    n = vr.shape[-1]
    if n not in SUPPORTED_C2C_SIZES:
        FS.split_factors(n)
    return FF.dispatch_planar(vr, vi, inverse=True, precision=precision,
                              scale=1.0 / n if norm == "backward" else 1.0)


def rfft_large(x: torch.Tensor, precision: str | None = None):
    """Planar huge-N R2C (N = 2**15..2**29): real (..., N) -> packed planar
    half-spectrum pair (..., N/2), slot 0 = (DC, Nyquist); unnormalized.
    Sizes 256..16384 route to :func:`rfft`."""
    x = api._as_real(x)
    n = x.shape[-1]
    if n in SUPPORTED_REAL_SIZES and n >= 256:
        return rfft(x, precision=precision)
    FS._check_real_n(n)
    if n < 1 << 15:
        raise ValueError(f"Error wrong FFT length! N={n}; planar rfft_large "
                         f"starts at 32768 (use rfft below)")
    return RF.rfft_large_planar(x, precision=precision)


def irfft_large(vr: torch.Tensor, vi: torch.Tensor, n: int | None = None,
                precision: str | None = None,
                norm: str | None = "backward"):
    """Planar huge-N C2R: packed half-spectrum pair (..., N/2) -> real
    (..., N).  ``norm="backward"`` gives the signal (the 1/(N/2) folded
    into the merge), ``norm=None`` the reference's raw scale."""
    _check_pair(vr, vi)
    n = n or vr.shape[-1] * 2
    if norm not in ("backward", None):
        raise ValueError(f"irfft_large supports norm='backward' or "
                         f"norm=None; got {norm!r}")
    if n in SUPPORTED_REAL_SIZES and n >= 256:
        return irfft(vr, vi, n=n, precision=precision, norm=norm)
    FS._check_real_n(n)
    if n < 1 << 15:
        raise ValueError(f"Error wrong FFT length! N={n}")
    return RF.irfft_large_planar(vr, vi, n, precision=precision,
                                 normalize=norm == "backward")
