"""Arbitrary-length DFT in one pass (Bluestein's chirp-z algorithm): the
Hopper kernel's wrapper and its plain version.

Counterpart of ``smfft_tpu/ops/chirp.py``.  An n-point DFT of any length is
a chirp multiply, one circular convolution of a supported power-of-two
length m >= 2n - 1, and a second chirp multiply:

    X_k = w_k sum_j (x_j w_j) conj(w)_{k-j},   w_j = exp(-i pi j^2 / n).

The hand-written CUDA kernel (``csrc/chirp.cu``, ``bluestein_kernel``, on
the Hopper core ``csrc/hcore.cuh``) does all of it per row in shared memory
and registers: the pre-chirp at the load, the m-point forward core (whose
first stage skips the zero half), the product with the chirp filter's
response (1/m folded in) in the registers where the forward core leaves
the spectrum, the m-point inverse core (whose last stage computes only the
points below m/2), and the post-chirp at the store.  Device memory sees only the caller's n-point rows; the
zero-extended m-point signal never leaves the block.  The inverse DFT is
the same kernel with the chirps and the response conjugated.

Rows: complex64 (B, n), or planar fp32 (B, n_pad) with the signal in the
first n lanes (n_pad = n rounded up to 128, the JAX package's lane
granule); the kernel writes lanes >= n as exact zeros.  The TPU kernel
re-indexes the response to its revblock spectrum order; here thread t of
the forward core ends holding the spectrum points t + s*TPF, which are the
inverse core's first operands, so the response stays in natural order and
no hand-off through shared memory remains.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel
(:func:`launch_bluestein`) or raises; a CPU tensor runs the plain version
(:func:`bluestein_plain`: ``c2c_plain`` forward, product, ``c2c_plain``
inverse), which never calls ``torch.fft``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from smfft_tpu_torch import api
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES


def n_pad(n: int) -> int:
    """n rounded up to the 128-lane granule of the planar rows."""
    return max(C.LANES, -(-n // C.LANES) * C.LANES)


@lru_cache(maxsize=None)
def chirp_consts(n: int, m: int):
    """(w (n,), h (m,)) complex128: the chirp w_j = exp(-i pi j^2 / n) and
    the chirp filter's natural-order response h = DFT_m(b) / m, b = conj(w)
    extended symmetrically (b[m - j] = b[j]).  Float64 host math; the phase
    uses the integer reduction j^2 mod 2n, exact at any n."""
    j = np.arange(n, dtype=np.int64)
    w = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(w)
    b[m - n + 1:] = np.conj(w[1:][::-1])
    h = np.fft.fft(b) / m                   # 1/m folded into the filter
    w.setflags(write=False)
    h.setflags(write=False)
    return w, h


def _table(a: np.ndarray, inverse: bool, dtype) -> torch.Tensor:
    """Complex (k,) -> (k, 2) (re, im) in ``dtype``, conjugated for the
    inverse."""
    a = np.conj(a) if inverse else a
    return torch.from_numpy(np.stack([a.real, a.imag], axis=-1).astype(dtype))


@lru_cache(maxsize=None)
def device_consts(n: int, m: int, inverse: bool, exact: bool,
                  device: torch.device):
    """The kernel's chirp (n, 2) and response (m, 2) tables on ``device``:
    float32, or float64 for the "exact" tier; conjugated for the
    inverse."""
    w, h = chirp_consts(n, m)
    dt = np.float64 if exact else np.float32
    return _table(w, inverse, dt).to(device), _table(h, inverse, dt).to(device)


def check_length(n: int, m: int) -> None:
    """n >= 1 and m a supported power of two >= 2n - 1."""
    if n < 1 or m not in SUPPORTED_C2C_SIZES or m < 2 * n - 1:
        raise ValueError(f"Error wrong FFT length! Bluestein n={n} needs a "
                         f"supported convolution length >= {2 * n - 1}, got "
                         f"m={m}")


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------


def bluestein_plain(xr: torch.Tensor, xi: torch.Tensor, n: int, m: int, *,
                    inverse: bool = False, scale: float | None = None,
                    exact: bool = False):
    """:func:`launch_bluestein`'s function in plain PyTorch: planar rows
    (B, ld), the signal in the first n lanes -> planar (B, ld), the n-point
    DFT (inverse DFT with ``inverse``) times ``scale`` in lanes 0..n-1 and
    zeros beyond, at the tier's precision (``c2c.at_tier``)."""
    check_length(n, m)

    def run(xr, xi):
        w, h = device_consts(n, m, inverse, xr.dtype == torch.float64,
                             xr.device)
        wr, wi, hr, hi = w[:, 0], w[:, 1], h[:, 0], h[:, 1]
        b, ld = xr.shape
        ar = torch.zeros((b, m), dtype=xr.dtype, device=xr.device)
        ai = torch.zeros_like(ar)
        ar[:, :n] = xr[:, :n] * wr - xi[:, :n] * wi   # pre-chirp
        ai[:, :n] = xr[:, :n] * wi + xi[:, :n] * wr
        fr, fi = C.c2c_plain(ar, ai)
        gr, gi = fr * hr - fi * hi, fr * hi + fi * hr   # chirp filter
        cr, ci = C.c2c_plain(gr, gi, inverse=True)
        cr, ci = cr[:, :n], ci[:, :n]
        s = 1.0 if scale is None else scale
        yr = torch.zeros((b, ld), dtype=xr.dtype, device=xr.device)
        yi = torch.zeros_like(yr)
        yr[:, :n] = (cr * wr - ci * wi) * s               # post-chirp
        yi[:, :n] = (cr * wi + ci * wr) * s
        return yr, yi
    return C.at_tier(run, exact, xr, xi)


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------


def launch_bluestein(x: torch.Tensor, xi: torch.Tensor | None = None, *,
                     n: int, m: int, inverse: bool = False,
                     scale: float | None = None, exact: bool = False):
    """Launch ``bluestein_kernel`` of ``csrc/chirp.cu`` on the current CUDA
    stream.

    ``x`` complex64 (B, ld) -> complex64 (B, ld); or ``x, xi`` planar
    float32 (B, ld) -> planar pair.  Lanes 0..n-1 of each output row hold the
    n-point DFT of the input's lanes 0..n-1 (the inverse DFT with
    ``inverse``) times ``scale``; lanes n..ld-1 are zeros.  m is the
    circular length (a supported power of two >= 2n - 1).  ``exact`` runs
    the fp64 arithmetic instantiation.  Outputs are allocated with
    ``torch.empty``.
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = 0
    try:
        check_length(n, m)
        _cuda.check_rows(x, xi)
        if x.shape[1] < n:
            raise ValueError(f"{'x' if xi is None else 'xr'} must be (batch, "
                             f"ld >= {n}), got {tuple(x.shape)}")
        a = sp and _T.now()
        out, ptrs = C.outputs(x, xi)
        b, ld = x.shape
        t = sp and _T.now()
        w, h = device_consts(n, m, bool(inverse), bool(exact), x.device)
        tw_f = C.device_twiddles(m, False, bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.BLUESTEIN, x.get_device(),
                     ("bluestein kernel launch (n={}, m={}, batch={})", n, m,
                      b),
                     *ptrs, int(xi is None), b, n, ld, m, w.data_ptr(),
                     h.data_ptr(), 1.0 if scale is None else float(scale),
                     tw_f.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:bluestein",
                        "interleaved" if xi is None else "planar", exact, b, n)
    return out


# ---------------------------------------------------------------------------
# Device dispatch and the JAX package's planar entry point.
# ---------------------------------------------------------------------------


def bluestein_rows(x: torch.Tensor, xi: torch.Tensor | None, n: int, m: int,
                   inverse: bool = False, scale: float | None = None,
                   exact: bool = False):
    """Rows (B, ld) (one complex tensor, or a planar pair with ``xi``) ->
    the n-point (inverse) DFT of lanes 0..n-1 times ``scale``, zeros beyond,
    in the same layout: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    kw = dict(n=n, m=m, inverse=inverse, scale=scale, exact=exact)
    if not C.is_cpu(x):
        return launch_bluestein(x, xi, **kw)
    if xi is None:
        return torch.complex(*bluestein_plain(x.real, x.imag, **kw))
    return bluestein_plain(x, xi, **kw)


def bluestein_planar(vr: torch.Tensor, vi: torch.Tensor, n: int, m: int,
                     precision: str = "highest"):
    """Arbitrary-length DFT in one pass: planar (B, n_pad) rows whose first n
    lanes hold the signal -> planar (B, n_pad) spectra, lanes >= n exactly
    zero.  m is the supported power-of-two convolution length >= 2n - 1
    (``chirp.bluestein_planar``)."""
    np_ = n_pad(n)
    if vr.shape[-1] != np_:
        raise ValueError(f"expected padded row width {np_}, got "
                         f"{vr.shape[-1]}")
    exact = api._exact(precision)
    return bluestein_rows(vr.to(torch.float32).contiguous(),
                          vi.to(torch.float32).contiguous(), n, m,
                          exact=exact)
