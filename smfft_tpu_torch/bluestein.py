"""Arbitrary-length FFTs by Bluestein's chirp-z algorithm.

The reference dispatches a fixed set of power-of-two sizes and prints
"Error wrong FFT length!" for everything else
(SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:656-658).  Here an n-point DFT of
any length n <= 8192 is a chirp multiply, a circular convolution of a
supported power-of-two length m >= 2n - 1, and a second chirp multiply,
all in one kernel pass (``csrc/chirp.cu``, :mod:`smfft_tpu_torch.ops.chirp`).
Supported power-of-two sizes go straight to :func:`smfft_tpu_torch.api.fft`.

``czt`` (scipy.signal.czt semantics, a spiral contour) and ``zoom_fft`` run
their convolution on the fused convolution kernel
(:func:`smfft_tpu_torch.api.convolve`), as in the JAX package.

The counterpart of ``smfft_tpu/bluestein.py``, with the same names,
signatures and errors.  ``backend="spec"`` runs the JAX package's composed
form (pad, convolve, slice) on the radix-2 specs, for debugging.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.ops import chirp as CH
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES

_MAX_M = max(SUPPORTED_C2C_SIZES)


def _conv_length(total: int) -> int:
    """Smallest supported power of two >= total (the circular length)."""
    m = max(32, 1 << (total - 1).bit_length())
    if m not in SUPPORTED_C2C_SIZES:
        raise ValueError(
            f"Error wrong FFT length! Bluestein needs a supported "
            f"convolution length >= {total}; max n is {_MAX_M // 2}")
    return m


@lru_cache(maxsize=None)
def _bluestein_consts(n: int):
    """(m, chirp (n,), filter response (m,)) as complex64, float64 host math:
    the composed form's constants (``backend="spec"``).

    The chirp phase -pi*j^2/n is reduced with integer j^2 mod 2n, so it is
    exact for any n (float64 j^2 loses ~1e-7 rad at n ~ 8192)."""
    m = _conv_length(2 * n - 1)
    j = np.arange(n, dtype=np.int64)
    ang = -np.pi * ((j * j) % (2 * n)) / n
    w = np.exp(1j * ang)                    # e^{-i pi j^2 / n}
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(w)
    b[m - n + 1:] = np.conj(w[1:][::-1])    # b[m-j] = b[j] (symmetric)
    fb = np.fft.fft(b)
    return m, w.astype(np.complex64), fb.astype(np.complex64)


def _complex(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.complex64 else x.to(torch.complex64)


def _spec_fft_any(x: torch.Tensor, n: int) -> torch.Tensor:
    """The composed form on the specs: chirp, pad, convolve, slice, chirp."""
    m, w, fb = _bluestein_consts(n)
    w = torch.from_numpy(w).to(x.device)
    a = torch.nn.functional.pad(x * w, (0, m - n))
    conv = api.convolve(a, torch.from_numpy(fb).to(x.device), backend="spec")
    return conv[..., :n] * w


def _any(x: torch.Tensor, inverse: bool, backend: str,
         precision: str | None, scale: float | None) -> torch.Tensor:
    """The n-point (inverse) DFT of complex (..., n) rows, n not a supported
    power of two, on the Bluestein kernel (or the spec)."""
    n = x.shape[-1]
    m = _conv_length(2 * n - 1)
    exact = api._exact(precision)
    api._check_backend(backend)
    if backend == "spec":
        out = (torch.conj(_spec_fft_any(torch.conj(x), n)) if inverse
               else _spec_fft_any(x, n))
        return out if scale is None else out * scale
    batch = x.shape[:-1]
    rows = x.reshape(-1, n).resolve_conj().contiguous()
    y = CH.bluestein_rows(rows, None, n, m, inverse=inverse, scale=scale,
                          exact=exact)
    return y.reshape(batch + (n,))


def fft_any(x: torch.Tensor, backend: api.Backend = "auto",
            precision: str | None = None) -> torch.Tensor:
    """Forward C2C FFT over the last axis at any length 1 <= n <= 8192.

    Supported power-of-two sizes dispatch straight to :func:`api.fft`;
    every other size runs Bluestein on the one-pass kernel."""
    x = _complex(x)
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    if n in SUPPORTED_C2C_SIZES:
        return api.fft(x, backend=backend, precision=precision)
    return _any(x, False, backend, precision, None)


def ifft_any(x: torch.Tensor, backend: api.Backend = "auto",
             precision: str | None = None,
             norm: str | None = "backward") -> torch.Tensor:
    """Inverse C2C FFT at any length; ``norm="backward"`` divides by n
    (fused into the kernel), ``norm=None`` is the raw inverse.  The same
    function as the JAX package's conjugation identity over
    :func:`fft_any`."""
    x = _complex(x)
    n = x.shape[-1]
    scale = api._norm_scale(norm, n)
    if n == 1:
        return x.clone()
    if n in SUPPORTED_C2C_SIZES:
        return api.ifft(x, backend=backend, precision=precision, norm=norm)
    return _any(x, True, backend, precision, scale)


def rfft_any(x: torch.Tensor, backend: api.Backend = "auto",
             precision: str | None = None) -> torch.Tensor:
    """R2C FFT at any length 1 <= n <= 8192: real (..., n) -> complex
    (..., n//2 + 1), numpy ``rfft`` layout.

    Supported power-of-two sizes dispatch to the real kernel
    (:func:`api.rfft`, half the traffic); every other size runs the
    Bluestein path and slices the one-sided half."""
    n = x.shape[-1]
    if x.is_complex():
        raise ValueError("rfft_any expects real input rows")
    if n in SUPPORTED_REAL_SIZES:
        return api.rfft(x, backend=backend, precision=precision)
    return fft_any(x, backend=backend, precision=precision)[..., :n // 2 + 1]


def irfft_any(x: torch.Tensor, n: int | None = None,
              backend: api.Backend = "auto", precision: str | None = None,
              norm: str | None = "backward") -> torch.Tensor:
    """C2R inverse FFT at any length: one-sided (..., n//2 + 1) complex ->
    real (..., n), numpy ``irfft`` semantics (``n`` defaults to
    2*(last-1); ``norm="backward"`` divides by n).

    Supported power-of-two sizes dispatch to the C2R kernel; other lengths
    rebuild the Hermitian spectrum (one gather and a conjugation) and run
    the Bluestein inverse."""
    if n is None:
        n = (x.shape[-1] - 1) * 2
    if n in SUPPORTED_REAL_SIZES:
        return api.irfft(x[..., :n // 2 + 1], n=n, backend=backend,
                         precision=precision, norm=norm)
    need = n // 2 + 1
    if x.shape[-1] < need:
        raise ValueError(f"spectrum has {x.shape[-1]} bins < {need} "
                         f"needed for n={n}")
    half = _complex(x[..., :need])
    # full spectrum: [X_0 .. X_h, conj(X_{n-need}) .. conj(X_1)]; the n-point
    # inverse's norm is irfft's
    mirror = torch.arange(n - need, 0, -1, device=x.device)
    full = torch.cat([half, half[..., mirror].conj()], dim=-1)
    return ifft_any(full, backend=backend, precision=precision,
                    norm=norm).real


@lru_cache(maxsize=None)
def _czt_consts(n: int, m: int, w: complex, a: complex):
    """Host float64 chirp constants for the general contour: input chirp
    a^{-j} w^{j^2/2} (n,), filter response (L,), output chirp w^{k^2/2}
    (m,)."""
    L = _conv_length(n + m - 1)
    wj = np.asarray(w, np.complex128)
    aj = np.asarray(a, np.complex128)
    j = np.arange(max(n, m), dtype=np.float64)
    logw = np.log(wj)                       # exact spiral handling
    chirp = np.exp(logw * (j * j) / 2.0)    # w^{j^2/2}
    in_chirp = (aj ** -j[:n]) * chirp[:n]
    out_chirp = chirp[:m]
    v = np.zeros(L, np.complex128)
    k = np.arange(m, dtype=np.float64)
    v[:m] = np.exp(-logw * (k * k) / 2.0)   # w^{-k^2/2}
    jj = np.arange(1, n, dtype=np.float64)
    v[L - n + 1:] = np.exp(-logw * (jj * jj) / 2.0)[::-1]
    fv = np.fft.fft(v)
    return (L, in_chirp.astype(np.complex64), fv.astype(np.complex64),
            out_chirp.astype(np.complex64))


def czt(x: torch.Tensor, m: int | None = None, w: complex | None = None,
        a: complex = 1.0 + 0.0j, backend: api.Backend = "auto",
        precision: str | None = None) -> torch.Tensor:
    """Chirp-z transform along a spiral contour (scipy.signal.czt
    semantics): X_k = sum_j x_j a^{-j} w^{jk}, k = 0..m-1.

    Defaults (m = n, w = e^{-2 pi i / m}, a = 1) give the DFT.  The
    convolution runs on the fused convolution kernel; the constants are
    float64 host math per (n, m, w, a)."""
    n = x.shape[-1]
    if m is None:
        m = n
    if w is None:
        w = np.exp(-2j * np.pi / m)
    L, in_chirp, fv, out_chirp = _czt_consts(n, m, complex(w), complex(a))
    dev = x.device
    sig = _complex(x) * torch.from_numpy(in_chirp).to(dev)
    conv = api.convolve(torch.nn.functional.pad(sig, (0, L - n)),
                        torch.from_numpy(fv).to(dev), backend=backend,
                        precision=precision)
    return conv[..., :m] * torch.from_numpy(out_chirp).to(dev)


def zoom_fft(x: torch.Tensor, fn, m: int | None = None, *, fs: float = 2.0,
             backend: api.Backend = "auto",
             precision: str | None = None) -> torch.Tensor:
    """Zoomed DFT over a frequency band (scipy.signal.zoom_fft): ``m``
    equally spaced bins of the DTFT on [f1, f2] without the full padded
    FFT.

    ``fn``: the band, a scalar f2 (band [0, f2]) or a pair (f1, f2), in the
    units of ``fs`` (the default fs = 2 makes frequencies fractions of the
    Nyquist rate).  One chirp-z on the fused convolution kernel."""
    n = x.shape[-1]
    if m is None:
        m = n
    if np.ndim(fn) == 0:
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = float(fn[0]), float(fn[1])
    # scipy's endpoint=False convention: bin step (f2 - f1) / (fs * m)
    w = np.exp(-2j * np.pi * (f2 - f1) / (fs * m))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m=m, w=complex(w), a=complex(a), backend=backend,
               precision=precision)
