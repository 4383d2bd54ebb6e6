"""Real transforms (R2C / C2R): the Hopper kernels' wrappers and their
plain versions.

Counterpart of ``smfft_tpu/ops/pallas_real.py`` and of the real halves of
``ops/pencil.py`` and ``ops/real_direct.py``.  Two hand-written CUDA kernels
(``csrc/real.cu``, ``csrc/c2r.cu``) compute

    R2C: real (B, n) -> packed half spectrum (B, L), L = n/2, slot 0 =
         (DC, Nyquist);
    C2R: packed half spectrum (B, L) -> scale * L * irfft (B, n), the
         reference's raw contract at scale 1;

for n = 64..16384, with the spectrum in one of four layouts (:data:`LAYOUTS`):

  * ``"planar"``     — two fp32 planes (B, L), natural bin order;
  * ``"planar_rev"`` — two fp32 planes, revblock order at size L (position
    ``k2*128 + k1`` holds bin ``k1*c + k2``, ``c = L/128``; natural for
    L <= 128), the layout of the JAX package's fused kernels;
  * ``"packed"``     — complex64 (B, L), slot 0 = DC + i*Nyquist;
  * ``"numpy"``      — complex64 (B, L+1), DC and Nyquist as real bins
    (C2R ignores their imaginary parts).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the kernel (:func:`launch_r2c`, :func:`launch_c2r`) or raises; a CPU tensor
runs the plain PyTorch version (:func:`r2c_plain`, :func:`c2r_plain`),
which is :func:`~smfft_tpu_torch.ops.c2c.c2c_plain` at size L plus the split
and merge in planar form.  It never calls ``torch.fft``, the oracle.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from smfft_tpu_torch import params as P
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C

LAYOUTS = ("planar", "planar_rev", "packed", "numpy")


def check_size(n: int) -> None:
    """The reference's static size switch for real lengths."""
    if n not in P.SUPPORTED_REAL_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}; supported: "
                         f"{P.SUPPORTED_REAL_SIZES}")


def _layout_code(layout: str) -> int:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    return LAYOUTS.index(layout)


def _revblock_perm(L: int) -> torch.Tensor:
    """perm[pos] = the bin stored at revblock position pos."""
    c = max(1, L // C.LANES)
    pos = torch.arange(L)
    return (pos % C.LANES) * c + pos // C.LANES


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def split_table(n: int, exact: bool, device: torch.device) -> torch.Tensor:
    """W_n^k, k < n/2, as (n/2, 2) (re, im) on ``device``: float32, or
    float64 for the "exact" tier (``params.real_split_table``)."""
    tab = P.real_split_table(n, "float64" if exact else "float32")
    return torch.from_numpy(tab.copy()).to(device)


def _mirror(a: torch.Tensor) -> torch.Tensor:
    """a[(L - k) mod L] along the last axis."""
    return torch.roll(torch.flip(a, [-1]), 1, -1)


def _split(zr, zi, n):
    """Half-size spectrum Z (natural) -> packed natural X, planar."""
    w = split_table(n, zr.dtype == torch.float64, zr.device)
    wr, wi = w[:, 0], w[:, 1]
    mr, mi = _mirror(zr), _mirror(zi)
    er, ei = 0.5 * (zr + mr), 0.5 * (zi - mi)   # (Z + conj Zm) / 2
    or_, oi = 0.5 * (zi + mi), 0.5 * (mr - zr)  # -i (Z - conj Zm) / 2
    xr = er + (wr * or_ - wi * oi)              # E + W^k O
    xi = ei + (wr * oi + wi * or_)
    xr = torch.cat([zr[:, :1] + zi[:, :1], xr[:, 1:]], dim=1)  # DC
    xi = torch.cat([zr[:, :1] - zi[:, :1], xi[:, 1:]], dim=1)  # Nyquist
    return xr, xi


def _merge(xr, xi, n, scale):
    """Packed natural X, planar -> scale * Z, the half-size spectrum."""
    w = split_table(n, xr.dtype == torch.float64, xr.device)
    wr, wi = w[:, 0], w[:, 1]
    h = 0.5 * (1.0 if scale is None else scale)
    mr, mi = _mirror(xr), _mirror(xi)
    er, ei = h * (xr + mr), h * (xi - mi)       # (X + conj Xm) / 2
    dr, di = h * (xr - mr), h * (xi + mi)       # (X - conj Xm) / 2
    or_, oi = dr * wr + di * wi, di * wr - dr * wi  # * W^-k
    zr, zi = er - oi, ei + or_                  # E + i O
    dc, nyq = xr[:, :1], xi[:, :1]
    zr = torch.cat([h * (dc + nyq), zr[:, 1:]], dim=1)
    zi = torch.cat([h * (dc - nyq), zi[:, 1:]], dim=1)
    return zr, zi


def to_layout(xr, xi, layout: str):
    """Packed natural planar X -> the layout's tensors."""
    L = xr.shape[-1]
    if layout == "planar":
        return xr, xi
    if layout == "planar_rev":
        perm = _revblock_perm(L).to(xr.device)
        return xr[:, perm], xi[:, perm]
    if layout == "packed":
        return torch.complex(xr, xi)
    zero = torch.zeros_like(xr[:, :1])
    return torch.complex(torch.cat([xr, xi[:, :1]], dim=1),
                         torch.cat([zero, xi[:, 1:], zero], dim=1))


def from_layout(spec, spec_im, layout: str, L: int):
    """The layout's tensors -> packed natural planar X."""
    if layout == "planar":
        return spec, spec_im
    if layout == "planar_rev":
        inv = torch.argsort(_revblock_perm(L)).to(spec.device)
        return spec[:, inv], spec_im[:, inv]
    if layout == "packed":
        return spec.real, spec.imag
    return (spec.real[:, :L],
            torch.cat([spec.real[:, L:], spec.imag[:, 1:L]], dim=1))


def r2c_plain(x: torch.Tensor, layout: str = "planar", exact: bool = False):
    """The R2C kernel's function in plain PyTorch: real (B, n) float32 or
    float64 -> the packed half spectrum in ``layout`` (a planar pair for
    the planar layouts, one complex tensor otherwise)."""
    _layout_code(layout)

    def run(a):
        n = a.shape[-1]
        zr, zi = C.c2c_plain(a[:, 0::2], a[:, 1::2])
        return to_layout(*_split(zr, zi, n), layout)
    return C.at_tier(run, exact, x)


def c2r_plain(spec: torch.Tensor, spec_im: torch.Tensor | None = None, *,
              n: int, layout: str = "planar", scale: float | None = None,
              exact: bool = False) -> torch.Tensor:
    """The C2R kernel's function in plain PyTorch: the packed half
    spectrum in ``layout`` (``spec, spec_im`` planes for the planar
    layouts, one complex tensor otherwise) -> real (B, n) equal to
    ``scale * (n/2) * irfft``."""
    _layout_code(layout)

    def run(*s):
        xr, xi = from_layout(s[0], s[1] if len(s) > 1 else None, layout,
                             n // 2)
        zr, zi = C.c2c_plain(*_merge(xr, xi, n, scale), inverse=True)
        return torch.stack([zr, zi], dim=-1).reshape(zr.shape[0], n)
    tensors = (spec,) if spec_im is None else (spec, spec_im)
    return C.at_tier(run, exact, *tensors)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def _spectrum_shape(layout: str, L: int) -> tuple[int, torch.dtype]:
    if layout in ("planar", "planar_rev"):
        return L, torch.float32
    return (L + 1 if layout == "numpy" else L), torch.complex64


def launch_r2c(x: torch.Tensor, layout: str = "planar", exact: bool = False):
    """Launch the R2C kernel of ``csrc/real.cu`` on the current CUDA stream.

    ``x`` float32 (B, n), contiguous, 8-byte aligned -> the packed half
    spectrum in ``layout`` (a planar pair, or one complex64 tensor),
    allocated with ``torch.empty``.  ``exact`` runs the fp64 arithmetic
    instantiation.
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        code = _layout_code(layout)
        if x.dim() != 2:
            raise ValueError(f"x must be (batch, n), got {tuple(x.shape)}")
        b, n = x.shape
        check_size(n)
        _cuda.check_rows(x, dtype=torch.float32)
        L = n // 2
        width, dtype = _spectrum_shape(layout, L)
        a = sp and _T.now()
        if dtype == torch.float32:
            out = (torch.empty((b, L), device=x.device),
                   torch.empty((b, L), device=x.device))
            o_re, o_im = out[0].data_ptr(), out[1].data_ptr()
        else:
            out = torch.empty((b, width), dtype=dtype, device=x.device)
            o_re, o_im = out.data_ptr(), None
        t = sp and _T.now()
        tw = C.device_twiddles(L, False, bool(exact), x.device)
        wn = split_table(n, bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.R2C, x.get_device(),
                     ("r2c kernel launch (n={}, batch={}, {})", n, b, layout),
                     x.data_ptr(), o_re, o_im, code, b, n, tw.data_ptr(),
                     wn.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:r2c", layout,
                        exact, b, n)
    return out


def launch_c2r(spec: torch.Tensor, spec_im: torch.Tensor | None = None, *,
               n: int, layout: str = "planar", scale: float | None = None,
               exact: bool = False) -> torch.Tensor:
    """Launch the C2R kernel of ``csrc/c2r.cu`` on the current CUDA stream.

    The packed half spectrum in ``layout`` (``spec, spec_im`` float32
    planes (B, n/2) for the planar layouts; one complex64 tensor, (B, n/2)
    packed or (B, n/2 + 1) numpy, otherwise) -> float32 (B, n) equal to
    ``scale * (n/2) * irfft``, allocated with ``torch.empty``.
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = 0
    try:
        code = _layout_code(layout)
        check_size(n)
        L = n // 2
        width, dtype = _spectrum_shape(layout, L)
        planar = dtype == torch.float32
        if planar != (spec_im is not None):
            raise ValueError(f"layout {layout!r} takes " + (
                "two planes" if planar else "one complex tensor"))
        _cuda.check_rows(spec, spec_im, dtype, width,
                         ("spec", "spec", "spec_im"))
        b = spec.shape[0]
        a = sp and _T.now()
        out = torch.empty((b, n), device=spec.device)
        t = sp and _T.now()
        tw = C.device_twiddles(L, True, bool(exact), spec.device)
        wn = split_table(n, bool(exact), spec.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.C2R, spec.get_device(),
                     ("c2r kernel launch (n={}, batch={}, {})", n, b, layout),
                     spec.data_ptr(),
                     None if spec_im is None else spec_im.data_ptr(), code,
                     out.data_ptr(), b, n,
                     1.0 if scale is None else float(scale), tw.data_ptr(),
                     wn.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:c2r", layout,
                        exact, b, n)
    return out


# ---------------------------------------------------------------------------
# Device dispatch and the JAX package's planar entry points.
# ---------------------------------------------------------------------------


def rfft_rows(x: torch.Tensor, layout: str, exact: bool = False):
    """Real rows (B, n) -> the half spectrum in ``layout``: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if C.is_cpu(x):
        return r2c_plain(x, layout, exact)
    return launch_r2c(x, layout, exact)


def irfft_rows(spec: torch.Tensor, spec_im: torch.Tensor | None = None, *,
               n: int, layout: str, scale: float | None = None,
               exact: bool = False) -> torch.Tensor:
    """The half spectrum in ``layout`` -> real rows (B, n), scaled as
    :func:`launch_c2r`, by device as :func:`rfft_rows`."""
    kw = dict(n=n, layout=layout, scale=scale, exact=exact)
    if C.is_cpu(spec):
        return c2r_plain(spec, spec_im, **kw)
    return launch_c2r(spec, spec_im, **kw)


def check_fused(n: int, what: str) -> None:
    """The planar real path's sizes: the real sizes from 256 up, as the
    JAX package's fused kernels and planar API take them."""
    if n < 256 or n not in P.SUPPORTED_REAL_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}; {what} requires "
                         f"real n in "
                         f"{[s for s in P.SUPPORTED_REAL_SIZES if s >= 256]}")


def rfft_planar(x: torch.Tensor, exact: bool = False, ordered: bool = False):
    """Real (B, n) float32 -> packed half spectrum as a planar (B, n/2)
    pair, slot 0 = (DC, Nyquist): revblock order by default, natural with
    ``ordered`` (``pallas_real.rfft_fused_planar``).  Requires n >= 256."""
    check_fused(x.shape[-1], "rfft_fused")
    return rfft_rows(x, "planar" if ordered else "planar_rev", exact)


def irfft_planar(vr: torch.Tensor, vi: torch.Tensor, n: int,
                 exact: bool = False, in_natural: bool = False,
                 scale: float | None = None) -> torch.Tensor:
    """Packed half spectrum planar (B, n/2) pair, revblock by default or
    natural with ``in_natural`` -> real (B, n) scaled by n/2 (reference
    contract) times ``scale`` (``pallas_real.irfft_fused_planar``).
    Requires n >= 256."""
    check_fused(n, "irfft_fused")
    return irfft_rows(vr, vi, n=n,
                      layout="planar" if in_natural else "planar_rev",
                      scale=scale, exact=exact)


def check_pack(batch: int, n: int) -> None:
    """The JAX package's batch rule for n = 64 / 128, whose half-size
    transform packs 128/L transforms per row: the batch must be a multiple
    of 128/L (4 at n = 64, 2 at n = 128)."""
    C.check_pack(batch, n // 2)


def rows_of(x: torch.Tensor, width: int):
    """(..., width) -> (contiguous (B, width) rows, batch shape, B)."""
    b = x.numel() // width
    return x.reshape(b, width).contiguous(), x.shape[:-1], b
