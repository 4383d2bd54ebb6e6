"""Huge-N real transforms (rfft_large / irfft_large): the split / merge
kernel's wrapper, its plain version, and the two packing modes.

Counterpart of ``smfft_tpu/ops/real_fused.py`` (B24-B26).  A real
transform of n = 2**15..2**29 samples is a complex transform (the passes of
ops/fourstep_fused.py) and one elementwise Hermitian pass of
``csrc/real_huge.cu`` (``real_huge_kernel``), or the pair split in the
plan's last pass:

  * "halfc" (B24): z[t] = x[2t] + i x[2t+1], read in place (a float32 row
    viewed as complex64), Z = FFT_L(z), L = n/2, then the split X[k] = E[k]
    + W_n^k O[k] with (DC, Nyquist) packed in slot 0; the inverse merges
    first and runs the inverse FFT_L into the output row;
  * "pair" (B25, B26): two real rows p, q ride as the real and imaginary
    planes of one complex row (the planar layout makes that free: the
    first half of the rows and the second), Z = FFT_n(x_p + i x_q), and
    the split writes X_p = (Z + conj Z[n-k]) / 2 and X_q = -i (Z - conj
    Z[n-k]) / 2 with no twiddle, in the plan's last pass where its radix
    is at most 256 (``fourstep_fused.pair_split_plan``: Z is never stored);
    the inverse merges two half-spectra into one Z whose inverse FFT holds
    x_p and x_q in its two planes.

Pairing couples the rows' rounding: x_p's spectrum carries rounding error
in proportion to the size of x_q's as well (one complex transform holds
both), so a small row paired with a large one gets the large one's error
scale.  "halfc" keeps every row to itself.

The mode (:func:`choose_mode`) is picked by the work each would run: pair
runs ceil(b/2) rows of n complex points (an odd batch pads one zero row),
halfc b rows of n/2, so pair is taken for an even batch and halfc for an
odd one (b = 1 in particular), and always halfc at n = 2**29, whose pair
transform would pass the C2C plans' 2**28.  The JAX package decides by n
alone and pads b = 1 to 16 rows (ROADMAP section B).

Spectra are packed (slot 0 = (DC, Nyquist)) as a planar pair, as complex64
("packed") or in numpy's layout (L + 1 bins); the kernel reads and writes
each directly.  Dispatch is by device: a CUDA tensor launches the kernels
or raises; a CPU tensor runs the plain versions, never ``torch.fft``.
"""

from __future__ import annotations

from functools import partial

import torch

from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import fourstep as FS
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import real as R

#: FFT lengths the pair mode can run (its complex transform is n long).
_PAIR_MAX = 1 << 28

MODES = ("pair", "halfc")
#: the kernel's spectrum layouts
SPEC_LAYOUTS = ("planar", "packed", "numpy")


def choose_mode(b: int, n: int) -> str:
    """"pair" or "halfc" for b rows of n samples, by the complex points
    each mode transforms: pair ceil(b/2) * n, halfc b * n/2 (ties to
    pair)."""
    if n > _PAIR_MAX:
        return "halfc"
    return "pair" if -(-b // 2) * n <= b * (n // 2) else "halfc"


def _mode(mode: str | None, b: int, n: int) -> str:
    mode = mode or choose_mode(b, n)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "pair" and n > _PAIR_MAX:
        raise ValueError(f"the pair mode needs n <= {_PAIR_MAX}; got n={n}")
    return mode


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel (complex Z, packed planar spectra).
# ---------------------------------------------------------------------------


def _w(n: int, count: int, z: torch.Tensor) -> torch.Tensor:
    """W_n^k, k < count, as the kernel forms it (hi/lo product)."""
    return FS.roots(torch.arange(count, device=z.device), n, False, z.dtype)


def halfc_split_plain(z: torch.Tensor, n: int):
    """Z = FFT_L(x[0::2] + i x[1::2]) (B, L) -> packed (B, L) planar X."""
    w = _w(n, n // 2, z)
    m = R._mirror(z).conj()
    e, o = 0.5 * (z + m), -0.5j * (z - m)
    x = e + w * o
    x[:, 0] = torch.complex(z[:, 0].real + z[:, 0].imag,
                            z[:, 0].real - z[:, 0].imag)
    return x.real, x.imag


def halfc_merge_plain(xr: torch.Tensor, xi: torch.Tensor, n: int,
                      scale: float):
    """Packed planar X (B, L) -> scale * the half-length Z whose inverse
    FFT_L is (L times) x[0::2] + i x[1::2]."""
    x = torch.complex(xr, xi)
    w = _w(n, n // 2, x)
    m = R._mirror(x).conj()
    h = 0.5 * scale
    z = h * (x + m) + 1j * (h * (x - m) * w.conj())
    z[:, 0] = torch.complex(h * (xr[:, 0] + xi[:, 0]),
                            h * (xr[:, 0] - xi[:, 0]))
    return z


def pair_split_plain(z: torch.Tensor, b: int):
    """Z = FFT_n(x_p + i x_q) (B2, n) -> packed planar spectra (b, L): rows
    r (of x_p = row r) and r + B2 (of x_q) for every Z row r; also the
    split pass's (``fourstep_fused.pass_plain``)."""
    b2, n = z.shape
    L = n // 2
    m = R._mirror(z).conj()[:, :L]
    zh = z[:, :L]
    p, q = 0.5 * (zh + m), -0.5j * (zh - m)
    p[:, 0] = torch.complex(z[:, 0].real, z[:, L].real)
    q[:, 0] = torch.complex(z[:, 0].imag, z[:, L].imag)
    x = torch.cat([p, q])[:b]
    return x.real, x.imag


def pair_merge_plain(xr: torch.Tensor, xi: torch.Tensor, b2: int,
                     scale: float):
    """Packed planar spectra (b, L) -> scale * Z (B2, n), Z = X_p + i X_q
    on bins < L and conj X_p + i conj X_q mirrored above; a missing q row
    (odd b) is zero."""
    b, L = xr.shape
    x = torch.complex(xr, xi)
    if 2 * b2 > b:
        x = torch.cat([x, torch.zeros((2 * b2 - b, L), dtype=x.dtype,
                                      device=x.device)])
    p, q = x[:b2], x[b2:]
    lo = p + 1j * q
    lo[:, 0] = torch.complex(p[:, 0].real, q[:, 0].real)
    nyq = torch.complex(p[:, 0].imag, q[:, 0].imag)[:, None]
    hi = torch.flip(p[:, 1:].conj() + 1j * q[:, 1:].conj(), [-1])
    return scale * torch.cat([lo, nyq, hi], dim=1)


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------


def _spec_args(spec, L: int):
    """(re pointer, im pointer, layout code, rows) of a spectrum operand: a
    planar float32 pair (B, L), or complex64 (B, L) packed / (B, L + 1)
    numpy."""
    if isinstance(spec, tuple):
        _cuda.check_rows(*spec, width=L, names=("spectrum plane",) * 3)
        return spec[0].data_ptr(), spec[1].data_ptr(), 0, spec[0].shape[0]
    width = spec.shape[-1] if spec.dim() == 2 else -1
    if width not in (L, L + 1):
        raise ValueError(f"spectrum must be (batch, {L}) packed or (batch, "
                         f"{L + 1}) numpy, got {tuple(spec.shape)}")
    _cuda.check_rows(spec, width=width, names=("spectrum",))
    return spec.data_ptr(), None, 1 if width == L else 2, spec.shape[0]


def launch_real_huge(mode: str, z: torch.Tensor, spec, n: int, *,
                     scale: float = 1.0, exact: bool = False) -> None:
    """Launch ``real_huge_kernel`` of ``csrc/real_huge.cu`` once on the
    current CUDA stream.  ``mode``: "pair_split", "pair_merge",
    "halfc_split", "halfc_merge".  ``z``: complex64 (complex128 for
    ``exact``) rows of n points (pair) or n/2 (halfc); ``spec``: the packed
    spectra (see :func:`_spec_args`), read by the merges and written by
    the splits; a pair's q spectra are the rows after the B2 p rows.
    Returns the operand it writes (``spec`` for a split, ``z`` for a
    merge), which may be given as a function that makes it, called here:
    the launch's ``alloc`` span."""
    sp = _T.on and _T.now()
    a = t = c = rows = out = 0
    try:
        codes = ("pair_split", "pair_merge", "halfc_split", "halfc_merge")
        if mode not in codes:
            raise ValueError(f"unknown mode {mode!r}; one of {codes}")
        if callable(z):
            a = sp and _T.now()
            z = out = z()
        elif callable(spec):
            a = sp and _T.now()
            spec = out = spec()
        L = n // 2
        pair = mode.startswith("pair")
        za, _, zk = FF._operand(z, n if pair else L, "z")
        xa, xb, layout, x_rows = _spec_args(spec, L)
        rows = z.shape[0]
        if (pair and not rows <= x_rows <= 2 * rows) or (not pair
                                                          and x_rows != rows):
            raise ValueError(f"{x_rows} spectra do not match {rows} rows of "
                             f"Z in mode {mode}")
        t = sp and _T.now()
        lo, hi = FS.device_roots(n, False, bool(exact), z.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.REAL_HUGE, z.get_device(),
                     ("real_huge kernel launch ({}, n={}, rows={})", mode, n,
                      rows),
                     codes.index(mode), za, zk, xa, xb, layout, rows, n,
                     rows if pair else 0, x_rows, float(scale),
                     lo.data_ptr(), hi.data_ptr(), FS.lo_bits(n), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:real_huge", mode,
                        exact, rows, n)
    return spec if mode.endswith("split") else z


def _alloc_spec(layout: str, b: int, L: int, device):
    if layout == "planar":
        return tuple(torch.empty((b, L), device=device) for _ in range(2))
    width = L if layout == "packed" else L + 1
    return torch.empty((b, width), dtype=torch.complex64, device=device)


def rfft_large_plain(x: torch.Tensor, layout: str = "planar",
                     exact: bool = False, mode: str | None = None):
    """:func:`rfft_large_rows`'s function in plain PyTorch, on any device:
    the plan's passes (``passes_plain``) and the split, at the tier's
    precision."""
    b, n = x.shape
    L, b2 = n // 2, -(-b // 2)
    mode = _mode(mode, b, n)

    def run(a):
        if mode == "halfc":
            z = FF.passes_plain(torch.complex(a[:, 0::2], a[:, 1::2]), L,
                                FF.default_passes(L))
            xr, xi = halfc_split_plain(z, n)
        else:
            if 2 * b2 > b:
                a = torch.cat([a, torch.zeros_like(a[:1])])
            z = FF.passes_plain(torch.complex(a[:b2], a[b2:]), n,
                                FF.default_passes(n))
            xr, xi = pair_split_plain(z, b)
        return R.to_layout(xr, xi, layout)
    return C.at_tier(run, exact, x)


def irfft_large_plain(spec: torch.Tensor, spec_im: torch.Tensor | None,
                      n: int, layout: str = "planar", exact: bool = False,
                      scale: float | None = None, mode: str | None = None):
    """:func:`irfft_large_rows`'s function in plain PyTorch, on any
    device."""
    L = n // 2
    s = 1.0 if scale is None else scale
    b = spec.shape[0]
    mode = _mode(mode, b, n)
    b2 = -(-b // 2)

    def run(*t):
        xr, xi = R.from_layout(t[0], t[1] if len(t) > 1 else None, layout, L)
        if mode == "halfc":
            z = FF.passes_plain(halfc_merge_plain(xr, xi, n, s), L,
                                FF.default_passes(L), inverse=True)
            return torch.stack([z.real, z.imag], -1).reshape(b, n)
        z = FF.passes_plain(pair_merge_plain(xr, xi, b2, 0.5 * s), n,
                            FF.default_passes(n), inverse=True)
        return torch.cat([z.real, z.imag])[:b]
    tensors = (spec, spec_im) if layout == "planar" else (spec,)
    return C.at_tier(run, exact, *tensors)


# ---------------------------------------------------------------------------
# Rows in, rows out.
# ---------------------------------------------------------------------------


def rfft_large_rows(x: torch.Tensor, layout: str = "planar",
                    exact: bool = False, mode: str | None = None):
    """Real (b, n) -> the packed half-spectra in ``layout`` ("planar": a
    float32 pair (b, n/2); "packed" complex64 (b, n/2); "numpy" complex64
    (b, n/2 + 1)).  Unnormalized."""
    if layout not in SPEC_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {SPEC_LAYOUTS}")
    b, n = x.shape
    FS._check_real_n(n)
    L = n // 2
    mode = _mode(mode, b, n)
    b2 = -(-b // 2)
    if C.is_cpu(x):
        return rfft_large_plain(x, layout, exact, mode)
    x = x.contiguous()
    # z and the spectrum are made by the launches that first write them
    new_z = partial(torch.empty, dtype=torch.complex128 if exact
                    else torch.complex64, device=x.device)
    new_spec = partial(_alloc_spec, layout, b, L, x.device)
    if mode == "halfc":
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32, got {x.dtype}")
        z = FF.run_passes(torch.view_as_complex(x.view(b, L, 2)), L,
                          FF.default_passes(L), exact=exact,
                          dst=partial(new_z, (b, L)))
        return launch_real_huge("halfc_split", z, new_spec, n, exact=exact)
    if 2 * b2 > b:
        x = torch.cat([x, torch.zeros_like(x[:1])])
    passes = FF.pair_split_plan(n)
    if passes[-1].split:
        # the last pass splits: no z, the spectra straight from its outputs
        return FF.run_passes((x[:b2], x[b2:]), n, passes, exact=exact,
                             dst=new_spec)
    z = FF.run_passes((x[:b2], x[b2:]), n, passes, exact=exact,
                      dst=partial(new_z, (b2, n)))
    return launch_real_huge("pair_split", z, new_spec, n, exact=exact)


def irfft_large_rows(spec: torch.Tensor, spec_im: torch.Tensor | None,
                     n: int, layout: str = "planar", exact: bool = False,
                     scale: float | None = None, mode: str | None = None):
    """Packed half-spectra in ``layout`` (``spec, spec_im`` planes for
    "planar") -> real (b, n) = scale * the reference's raw (n/2)-scaled
    C2R (``scale`` None: 1)."""
    if layout not in SPEC_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {SPEC_LAYOUTS}")
    FS._check_real_n(n)
    L = n // 2
    s = 1.0 if scale is None else scale
    b = spec.shape[0]
    mode = _mode(mode, b, n)
    b2 = -(-b // 2)
    operand = (spec, spec_im) if layout == "planar" else spec
    if C.is_cpu(spec):
        return irfft_large_plain(spec, spec_im, n, layout, exact, scale,
                                 mode)
    # z and the signal are made by the launches that first write them
    new_z = partial(torch.empty, dtype=torch.complex128 if exact
                    else torch.complex64, device=spec.device)
    if mode == "halfc":
        z = launch_real_huge("halfc_merge", partial(new_z, (b, L)), operand,
                             n, scale=s, exact=exact)
        y = FF.run_passes(z, L, FF.default_passes(L), inverse=True,
                          exact=exact, dst=lambda: torch.view_as_complex(
                              torch.empty((b, L, 2), device=spec.device)))
        return torch.view_as_real(y).view(b, n)
    z = launch_real_huge("pair_merge", partial(new_z, (b2, n)), operand, n,
                         scale=0.5 * s, exact=exact)
    signal = None

    def planes():       # x_p's rows, then x_q's, in one block
        nonlocal signal
        signal = torch.empty((2 * b2, n), device=spec.device)
        return signal[:b2], signal[b2:]
    FF.run_passes(z, n, FF.default_passes(n), inverse=True, exact=exact,
                  dst=planes)
    return signal[:b]


# ---------------------------------------------------------------------------
# The JAX package's planar entry points.
# ---------------------------------------------------------------------------


def rfft_large_planar(x: torch.Tensor, *, precision: str | None = None,
                      mode: str | None = None):
    """Huge-N planar R2C: real (..., N) -> packed planar half-spectrum pair
    (..., N/2), slot 0 = (DC, Nyquist).  N = 2**15..2**29 (power of two);
    unnormalized.  ``mode``: "pair", "halfc" or None (:func:`choose_mode`)."""
    from smfft_tpu_torch import api
    n = x.shape[-1]
    batch, L = x.shape[:-1], n // 2
    rows = x.reshape(-1, n)
    if not C.is_cpu(rows):
        rows = rows.to(torch.float32)
    hr, hi = rfft_large_rows(rows, "planar", api._exact(precision), mode)
    return hr.reshape(batch + (L,)), hi.reshape(batch + (L,))


def irfft_large_planar(hr: torch.Tensor, hi: torch.Tensor, n: int, *,
                       precision: str | None = None, normalize: bool = True,
                       mode: str | None = None):
    """Huge-N planar C2R: packed half-spectrum pair (..., N/2) -> real
    (..., N).  ``normalize`` divides by N/2 (numpy's signal);
    ``normalize=False`` keeps the reference's raw (N/2)-scale
    (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  ``mode`` as in
    :func:`rfft_large_planar`."""
    from smfft_tpu_torch import api
    if hr.shape != hi.shape:
        raise ValueError(f"planar pair shapes differ: {tuple(hr.shape)} vs "
                         f"{tuple(hi.shape)}")
    L = n // 2
    if hr.shape[-1] != L:
        raise ValueError(f"packed half-spectrum needs {L} lanes for N={n}, "
                         f"got {hr.shape[-1]}")
    batch = hr.shape[:-1]
    r = hr.reshape(-1, L).contiguous()
    i = hi.reshape(-1, L).contiguous()
    if not C.is_cpu(r):
        r, i = r.to(torch.float32), i.to(torch.float32)
    out = irfft_large_rows(r, i, n, "planar", api._exact(precision),
                           1.0 / L if normalize else None, mode)
    return out.reshape(batch + (n,))
