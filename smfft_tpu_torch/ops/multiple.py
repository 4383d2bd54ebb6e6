"""The reuse loops: many transforms of data that stays on chip.

Counterpart of the reuse forms of ``smfft_tpu/ops/pallas_c2c.py``
(``fft_planar(multiple_iters=k)``) and ``smfft_tpu/ops/pencil.py``
(``multiple_pencil_planar``, ``multiple_real_pencil_planar``): the
reference's ``FFT_multiple_benchmark``, where one load feeds many
applications of the core before one store.  Two hand-written CUDA kernels
(``csrc/multiple.cu``):

  * :func:`launch_multiple` — ``loops + 1`` C2C transforms of every row:
    the first reads natural input times ``scale``; after each of the
    first ``loops`` transforms the spectrum, times 1/sqrt(N), is handed to
    the next one in revblock order (``fb_rev``; ``last_rev`` for the last
    hand-off) or natural order; the output is natural or revblock
    (``rev_out``).  fp32 and "exact" instantiations.
  * :func:`launch_real_multiple` — ``pairs`` round trips R2C -> C2R, the
    C2R scaled by 1/L (L = n/2), so the output is the input up to rounding.

Dispatch is by the tensor's device, as everywhere in the package: a CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain versions
(:func:`multiple_plain`, :func:`real_multiple_plain`), which repeat
``c2c_plain`` and ``r2c_plain`` / ``c2r_plain``.

"Pencil" in the JAX names is the TPU layout those kernels transpose rows
into; the function, not the layout, is what this module keeps.  Unlike the
JAX pencil path, the kernels mask a ragged batch, so nothing is padded.
"""

from __future__ import annotations

import math

import torch

from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R


def check_pencil(n: int, lo: int = 32, hi: int = 4096) -> None:
    """The JAX pencil path's size gate: a power of two in [lo, hi]."""
    if not lo <= n <= hi or n & (n - 1):
        raise ValueError(
            f"Error wrong FFT length! pencil path supports power-of-two "
            f"{lo} <= n <= {hi}, got {n}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def multiple_plain(xr: torch.Tensor, xi: torch.Tensor, *, loops: int,
                   inverse: bool = False, fb_rev: bool = False,
                   last_rev: bool = False, rev_out: bool = False,
                   scale: float | None = None, exact: bool = False):
    """:func:`launch_multiple`'s function in plain PyTorch on planar
    (B, n) pairs, at the tier's precision (``c2c.at_tier``)."""
    n = xr.shape[-1]
    s = 1.0 / math.sqrt(n)

    def run(a, b):
        if scale is not None:
            a, b = a * scale, b * scale
        for it in range(loops):
            rev = last_rev if it == loops - 1 else fb_rev
            a, b = C.c2c_plain(a, b, inverse=inverse, rev_out=rev)
            a, b = a * s, b * s
        return C.c2c_plain(a, b, inverse=inverse, rev_out=rev_out)
    return C.at_tier(run, exact, xr, xi)


def real_multiple_plain(x: torch.Tensor, pairs: int) -> torch.Tensor:
    """:func:`launch_real_multiple`'s function in plain PyTorch: ``pairs``
    round trips ``r2c_plain`` -> ``c2r_plain`` at scale 1/L."""
    n = x.shape[-1]
    for _ in range(pairs):
        x = R.c2r_plain(*R.r2c_plain(x, "planar"), n=n, scale=2.0 / n)
    return x


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def launch_multiple(x: torch.Tensor, xi: torch.Tensor | None = None, *,
                    loops: int, inverse: bool = False, fb_rev: bool = False,
                    last_rev: bool = False, rev_out: bool = False,
                    scale: float | None = None, exact: bool = False):
    """Launch ``c2c_multiple_kernel`` of ``csrc/multiple.cu`` on the
    current CUDA stream.

    ``x`` complex64 (B, n) -> complex64 (B, n); or ``x, xi`` planar
    float32 (B, n) -> planar pair, allocated with ``torch.empty``.
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if loops < 0:
            raise ValueError(f"loops must be >= 0, got {loops}")
        a = sp and _T.now()
        _cuda.check_rows(x, xi)
        b, n = x.shape
        C.check_size(n)
        out, ptrs = C.outputs(x, xi)
        t = sp and _T.now()
        tw = C.device_twiddles(n, bool(inverse), bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.C2C_MULTIPLE, x.get_device(),
                     ("c2c_multiple kernel launch (n={}, batch={}, "
                      "loops={})", n, b, loops),
                     *ptrs, int(xi is None), b, n, int(inverse), int(loops),
                     int(fb_rev), int(last_rev), int(rev_out),
                     1.0 if scale is None else float(scale),
                     1.0 / math.sqrt(n), tw.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:c2c_multiple",
                        "interleaved" if xi is None else "planar", exact, b, n)
    return out


def launch_real_multiple(x: torch.Tensor, pairs: int) -> torch.Tensor:
    """Launch ``real_multiple_kernel`` of ``csrc/multiple.cu`` on the
    current CUDA stream: float32 (B, n), n = 256..4096, contiguous and
    8-byte aligned -> float32 (B, n) after ``pairs`` >= 1 round trips."""
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if x.dim() != 2:
            raise ValueError(f"x must be (batch, n), got {tuple(x.shape)}")
        b, n = x.shape
        check_pencil(n, 256, 4096)
        _cuda.check_rows(x, dtype=torch.float32)
        if pairs < 1:
            raise ValueError(f"pairs must be >= 1, got {pairs}")
        L = n // 2
        a = sp and _T.now()
        out = torch.empty_like(x)
        t = sp and _T.now()
        tw_f = C.device_twiddles(L, False, False, x.device)
        tw_i = C.device_twiddles(L, True, False, x.device)
        wn = R.split_table(n, False, x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.REAL_MULTIPLE, x.get_device(),
                     ("real_multiple kernel launch (n={}, batch={}, "
                      "pairs={})", n, b, pairs),
                     x.data_ptr(), out.data_ptr(), b, n, int(pairs),
                     tw_f.data_ptr(), tw_i.data_ptr(), wn.data_ptr())
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:real_multiple",
                        f"pairs={pairs}", False, b, n)
    return out


# ---------------------------------------------------------------------------
# Device dispatch and the JAX package's entry points.
# ---------------------------------------------------------------------------


def multiple_rows(xr: torch.Tensor, xi: torch.Tensor, **kw):
    """Planar (B, n) rows through :func:`launch_multiple` on a CUDA
    tensor, :func:`multiple_plain` on a CPU tensor."""
    if C.is_cpu(xr):
        return multiple_plain(xr, xi, **kw)
    return launch_multiple(xr, xi, **kw)


def fft_planar_multiple(vr: torch.Tensor, vi: torch.Tensor, n: int,
                        iters: int, inverse: bool = False,
                        rev_in: bool = False, ordered: bool = False,
                        scale: float | None = None, exact: bool = False):
    """``fft_planar(multiple_iters=iters)`` on (B, n) rows: ``iters``
    re-applications of kernel A (natural in, revblock out) times 1/sqrt(N),
    each revblock row read back as natural input, then one unscaled
    transform with ``fft_planar``'s own layouts (revblock or, with
    ``ordered``, natural out; with ``rev_in``, revblock in and natural
    out, where the last hand-off's two revblock maps cancel)."""
    return multiple_rows(vr, vi, loops=iters, inverse=inverse, fb_rev=True,
                         last_rev=not rev_in,
                         rev_out=not (ordered or rev_in), scale=scale,
                         exact=exact)


def multiple_pencil_planar(vr: torch.Tensor, vi: torch.Tensor, n: int,
                           iters: int, inverse: bool = False):
    """``iters`` applications of the natural-order FFT, each scaled by
    1/sqrt(n), to planar fp32 rows (B, n), one transform per row at any n
    (no 128/n row packing), 32 <= n <= 4096: ``pencil.
    multiple_pencil_planar``.  ``iters = 0`` returns copies, as the JAX
    loop returns its input."""
    check_pencil(n)
    if vr.shape[-1] != n:
        raise ValueError(f"expected row width {n}, got {vr.shape[-1]}")
    if iters == 0:
        return vr.clone(), vi.clone()
    return multiple_rows(vr.contiguous(), vi.contiguous(), loops=iters - 1,
                         inverse=inverse, scale=1.0 / math.sqrt(n))


def multiple_real_pencil_planar(x: torch.Tensor, n: int, iters: int):
    """``iters`` real-transform applications (``iters/2`` R2C -> C2R round
    trips, the C2R scaled by 1/L) to fp32 rows (B, n), 256 <= n <= 4096:
    the output equals the input up to fp32 rounding
    (``pencil.multiple_real_pencil_planar``).  ``iters`` must be even."""
    check_pencil(n, 256, 4096)
    if iters % 2:
        raise ValueError("iters must be even (R2C->C2R pairs)")
    if x.shape[-1] != n:
        raise ValueError(f"expected row width {n}, got {x.shape[-1]}")
    x = x.to(torch.float32).contiguous()
    if iters == 0:
        return x.clone()
    if C.is_cpu(x):
        return real_multiple_plain(x, iters // 2)
    return launch_real_multiple(x, iters // 2)
