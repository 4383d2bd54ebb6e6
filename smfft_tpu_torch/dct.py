"""Discrete cosine/sine transforms (types I-IV) over the FFT kernels.

The counterpart of ``smfft_tpu/dct.py``: scipy.fft-compatible ``dct`` /
``idct`` / ``dst`` / ``idst`` and their N-D forms, with the same names,
signatures and errors.  The workhorse types 2 and 3 (scipy's defaults;
type 3 is type 2's unnormalized transpose) use the classic O(n log n)
reduction (Makhoul 1980): a DCT-II of length n is an n-point real FFT of
the even/odd-reordered sequence followed by a quarter-wave twiddle —

    v = [x_0, x_2, ..., x_{n-2}, x_{n-1}, ..., x_3, x_1]
    X_k = 2 * Re( e^{-i pi k / 2n} * V_k ),   V = FFT(v)

so the transform is one launch of the R2C kernel (``csrc/real.cu``)
between a reordering copy and an elementwise twiddle; DCT-III runs the
same recipe backwards through the C2R kernel (``csrc/c2r.cu``: solve V_k
from the X_k / X_{n-k} pair, inverse real FFT, un-reorder).  DST-II/III
ride the exact identity DST-II(x)_k = DCT-II(sx)_{n-1-k} with (sx)_j =
(-1)^j x_j.

Type 1 is the real FFT of the even (DCT) / odd (DST) symmetric
extension: DCT-I of length n = Re(rfft) of the 2(n-1)-point extension
[x_0..x_{n-1}, x_{n-2}..x_1] (so n = 2^m + 1), DST-I of length n =
-Im(rfft)[1:] of the 2(n+1)-point extension [0, x, 0, -reverse(x)]
(n = 2^m - 1).  Type 4 folds the (2j+1)(2k+1) kernel into one length-2n
C2C pass (``csrc/c2c.cu``) with exact eighth-wave pre/post twiddles;
DST-IV rides DST-IV(x)_k = (-1)^k DCT-IV(reverse(x))_k.

Transform lengths follow the kernel contracts (powers of two for types
2-4; 2^m +- 1 for type 1).  ``norm=None`` (scipy raw scaling) and
``norm="ortho"`` (orthonormal) are supported; scipy.fft round-trip
semantics (``idct(dct(x, type=t), type=t) == x``) hold for every type
and both norms.  Integer, bool and half-precision inputs are promoted to
float32, as the JAX package does; a CPU float64 input keeps float64.  The
twiddle and scale rows are computed in float64, rounded once to the
input's precision and kept on the input's device (made once per size,
precision and device).  Gradients flow through the transforms' own
autograd Functions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.ndim import _apply_last, _norm_axes
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES


def _check_n(n: int):
    if n not in SUPPORTED_REAL_SIZES:
        raise ValueError(
            f"Error wrong FFT length! N={n}; supported: "
            f"{SUPPORTED_REAL_SIZES}")


# ---------------------------------------------------------------------------
# Constant rows: float64 on the host, rounded once, cached on the device.
# ---------------------------------------------------------------------------


def _twiddles(n: int):
    """Quarter-wave rows: cos/sin of pi*k/(2n) for k = 0..n/2."""
    th = np.pi * np.arange(n // 2 + 1, dtype=np.float64) / (2.0 * n)
    return np.cos(th), np.sin(th)


def _eighth_twiddles(n: int):
    """Eighth-wave rows: the DCT-IV pre twiddle e^{-i pi j/(2n)} and post
    twiddle e^{-i pi (2k+1)/(4n)}, as (pre re, pre im, post re, post
    im)."""
    j = np.arange(n, dtype=np.float64)
    pre = np.exp(-1j * np.pi * j / (2.0 * n))
    post = np.exp(-1j * np.pi * (2.0 * j + 1.0) / (4.0 * n))
    return pre.real, pre.imag, post.real, post.imag


def _ortho_scale(n: int, last: bool = False):
    """Orthonormalization row: sqrt(1/2n) everywhere, sqrt(1/4n) at
    index 0 (DCT) or n-1 (DST, ``last=True``)."""
    s = np.full(n, np.sqrt(1.0 / (2.0 * n)))
    s[n - 1 if last else 0] = np.sqrt(1.0 / (4.0 * n))
    return (s,)


def _ortho_in(n: int, last: bool = False):
    """The ortho type-3 input weights ((ortho type 2)^T = the raw type 3
    with its input columns scaled): sqrt(1/2n) everywhere, sqrt(1/n) at
    index 0 (DCT) or n-1 (DST, ``last=True``)."""
    w = np.full(n, np.sqrt(1.0 / (2.0 * n)))
    w[n - 1 if last else 0] = np.sqrt(1.0 / n)
    return (w,)


def _dct1_ends(n: int):
    """The ortho DCT-I end weights: sqrt(2) at indices 0 and n-1."""
    f = np.ones(n)
    f[0] = f[n - 1] = np.sqrt(2.0)
    return (f,)


def _signs(n: int):
    return ((-1.0) ** np.arange(n),)


@lru_cache(maxsize=None)
def _device_rows(make, n: int, dtype: torch.dtype, device: torch.device,
                 *args) -> tuple[torch.Tensor, ...]:
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np_dtype)).to(
        device) for a in make(n, *args))


def _rows(make, n: int, like: torch.Tensor, *args):
    """``make(n, *args)``'s float64 rows, rounded once to ``like``'s real
    precision, on ``like``'s device."""
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return _device_rows(make, n, dtype, like.device, *args)


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, [-1])


# ---------------------------------------------------------------------------
# types 2 and 3
# ---------------------------------------------------------------------------


def _dct2_raw(x, backend, precision):
    """scipy dct type 2, norm=None: X_k = 2 sum x_j cos(pi k(2j+1)/2n)."""
    n = x.shape[-1]
    h = n // 2
    v = api._as_real(torch.cat([x[..., 0::2], _flip(x[..., 1::2])], -1))
    spec = api.rfft(v, backend=backend, precision=precision)
    vr, vi = spec.real, spec.imag
    c, s = _rows(_twiddles, n, vr)
    # k = 0..h: X_k = 2 (Vr cos + Vi sin)
    lo = 2.0 * (vr * c + vi * s)
    # k = h+1..n-1 via the Hermitian mirror m = n-k = h-1..1:
    # X_{n-m} = 2 (Vr_m sin - Vi_m cos)
    hi = 2.0 * (vr[..., 1:h] * s[1:h] - vi[..., 1:h] * c[1:h])
    return torch.cat([lo, _flip(hi)], -1)


def _dct3_raw(x, backend, precision):
    """scipy dct type 3, norm=None:
    X_j = x_0 + 2 sum_{k>=1} x_k cos(pi k(2j+1)/2n)  ( = 2n * the exact
    inverse of _dct2_raw).  Solves the one-sided spectrum from the
    (x_k, x_{n-k}) pairs and runs the C2R kernel."""
    x = api._as_real(x)
    n = x.shape[-1]
    h = n // 2
    c, s = _rows(_twiddles, n, x)
    xk = x[..., 1:h]
    xnk = _flip(x[..., h + 1:])              # x_{n-k}, k = 1..h-1
    vr = 0.5 * (xk * c[1:h] + xnk * s[1:h])
    vi = 0.5 * (xk * s[1:h] - xnk * c[1:h])
    v0 = 0.5 * x[..., 0:1]
    nyq = x[..., h:h + 1] * (0.5 * np.sqrt(2.0))
    spec = torch.complex(
        torch.cat([v0, vr, nyq], -1),
        torch.cat([torch.zeros_like(v0), vi, torch.zeros_like(nyq)], -1))
    v = api.irfft(spec, n=n, backend=backend, precision=precision,
                  norm="backward")           # exact inverse DFT
    evens, odds = v[..., :h], _flip(v[..., h:])
    out = torch.stack([evens, odds], -1).reshape(x.shape)
    return out * (2.0 * n)


# ---------------------------------------------------------------------------
# types 1 and 4
# ---------------------------------------------------------------------------


def _check_dct1_n(n: int):
    if (n - 1) * 2 not in SUPPORTED_REAL_SIZES:
        raise ValueError(
            f"Error wrong FFT length! DCT-I N={n} needs 2(N-1) in "
            f"{SUPPORTED_REAL_SIZES} (N = 2^m + 1, 33..8193)")


def _check_dst1_n(n: int):
    if (n + 1) * 2 not in SUPPORTED_REAL_SIZES:
        raise ValueError(
            f"Error wrong FFT length! DST-I N={n} needs 2(N+1) in "
            f"{SUPPORTED_REAL_SIZES} (N = 2^m - 1, 31..8191)")


def _check_dct4_n(n: int):
    if 2 * n not in SUPPORTED_C2C_SIZES:
        raise ValueError(
            f"Error wrong FFT length! type-4 N={n} needs 2N in "
            f"{SUPPORTED_C2C_SIZES}")


def _dct1_raw(x, backend, precision):
    """scipy dct type 1, norm=None:
    X_k = x_0 + (-1)^k x_{n-1} + 2 sum_{j=1}^{n-2} x_j cos(pi jk/(n-1)),
    computed as Re(rfft) of the even-symmetric 2(n-1)-point extension."""
    n = x.shape[-1]
    v = api._as_real(torch.cat([x, _flip(x[..., 1:n - 1])], -1))
    return api.rfft(v, backend=backend, precision=precision).real


def _dst1_raw(x, backend, precision):
    """scipy dst type 1, norm=None:
    X_k = 2 sum_j x_j sin(pi (j+1)(k+1)/(n+1)), computed as -Im(rfft)[1:]
    of the odd-symmetric 2(n+1)-point extension [0, x, 0, -reverse(x)]."""
    n = x.shape[-1]
    x = api._as_real(x)
    z = torch.zeros_like(x[..., :1])
    v = torch.cat([z, x, z, -_flip(x)], -1)
    spec = api.rfft(v, backend=backend, precision=precision)
    return -spec.imag[..., 1:n + 1]


def _dct4_raw(x, backend, precision):
    """scipy dct type 4, norm=None:
    X_k = 2 sum_j x_j cos(pi (2j+1)(2k+1)/(4n)) — the (2j+1)(2k+1) phase
    splits as jk/n + j/(2n) + k/(2n) + 1/(4n), so one zero-padded
    length-2n C2C pass with eighth-wave pre/post twiddles computes it
    exactly (the jk/n half-frequency kernel is the even-index-free
    DFT_2n)."""
    n = x.shape[-1]
    x = api._as_real(x)
    pre_r, pre_i, post_r, post_i = _rows(_eighth_twiddles, n, x)
    pad = torch.zeros_like(x)
    a = torch.complex(torch.cat([x * pre_r, pad], -1),
                      torch.cat([x * pre_i, pad], -1))
    big = api.fft(a, backend=backend, precision=precision)[..., :n]
    return 2.0 * (post_r * big.real - post_i * big.imag)


def _type1(x, dst: bool, norm, backend, precision):
    n = x.shape[-1]
    if dst:
        _check_dst1_n(n)
        raw = _dst1_raw
        denom = 2.0 * (n + 1)
    else:
        _check_dct1_n(n)
        raw = _dct1_raw
        denom = 2.0 * (n - 1)
    if norm != "ortho":
        return raw(x, backend, precision), denom
    if dst:
        # orthonormal DST-I matrix is raw/sqrt(2(n+1)), symmetric
        return raw(x, backend, precision) / float(np.sqrt(denom)), 1.0
    # orthonormal DCT-I: scale x_0, x_{n-1} by sqrt(2) in, y_0, y_{n-1}
    # by 1/sqrt(2) out, whole by 1/sqrt(2(n-1)) (scipy's convention)
    x = api._as_real(x)
    (f,) = _rows(_dct1_ends, n, x)
    out = raw(x * f, backend, precision) / f
    return out / float(np.sqrt(denom)), 1.0


def _type4(x, dst: bool, norm, backend, precision):
    n = x.shape[-1]
    _check_dct4_n(n)
    if dst:
        out = _dct4_raw(_flip(x), backend, precision)
        out = out * _rows(_signs, n, out)[0]
    else:
        out = _dct4_raw(x, backend, precision)
    if norm == "ortho":
        return out / float(np.sqrt(2.0 * n)), 1.0
    return out, 2.0 * n


def _signed(x: torch.Tensor) -> torch.Tensor:
    """(-1)^j x_j along the last axis."""
    x = api._as_real(x)
    return x * _rows(_signs, x.shape[-1], x)[0]


def dct(x: torch.Tensor, type: int = 2, norm: str | None = None,
        backend: api.Backend = "auto",
        precision: str | None = None) -> torch.Tensor:
    """DCT over the last axis (scipy.fft.dct, types 1-4)."""
    n = x.shape[-1]
    if type == 1:
        return _type1(x, False, norm, backend, precision)[0]
    if type == 4:
        return _type4(x, False, norm, backend, precision)[0]
    _check_n(n)
    if type == 2:
        out = _dct2_raw(x, backend, precision)
        if norm == "ortho":
            out = out * _rows(_ortho_scale, n, out)[0]
        return out
    if type == 3:
        if norm == "ortho":
            # ortho DCT-III = (ortho DCT-II)^T = _dct3_raw with input
            # columns scaled by [sqrt(1/n), sqrt(1/2n), ...]
            x = api._as_real(x)
            x = x * _rows(_ortho_in, n, x)[0]
        return _dct3_raw(x, backend, precision)
    raise ValueError(f"dct type {type} not supported (types 1-4)")


def idct(x: torch.Tensor, type: int = 2, norm: str | None = None,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """Inverse DCT (scipy.fft.idct): ``idct(dct(x, type=t, norm=m),
    type=t, norm=m) == x`` for both norms, all four types.  Types 1 and
    4 are involutions: the inverse is the forward scaled by 1/(2(N-1))
    resp. 1/(2N) (exactly 1 for ortho)."""
    n = x.shape[-1]
    if type == 1:
        out, denom = _type1(x, False, norm, backend, precision)
        return out / denom if denom != 1.0 else out
    if type == 4:
        out, denom = _type4(x, False, norm, backend, precision)
        return out / denom if denom != 1.0 else out
    _check_n(n)
    if type == 2:
        if norm == "ortho":
            return dct(x, type=3, norm="ortho", backend=backend,
                       precision=precision)
        return _dct3_raw(x, backend, precision) / (2.0 * n)
    if type == 3:
        if norm == "ortho":
            return dct(x, type=2, norm="ortho", backend=backend,
                       precision=precision)
        return _dct2_raw(x, backend, precision) / (2.0 * n)
    raise ValueError(f"idct type {type} not supported (types 1-4)")


def dst(x: torch.Tensor, type: int = 2, norm: str | None = None,
        backend: api.Backend = "auto",
        precision: str | None = None) -> torch.Tensor:
    """DST over the last axis (scipy.fft.dst, types 1-4) via
    DST-II(x)_k = DCT-II(sx)_{n-1-k}, (sx)_j = (-1)^j x_j."""
    n = x.shape[-1]
    if type == 1:
        return _type1(x, True, norm, backend, precision)[0]
    if type == 4:
        return _type4(x, True, norm, backend, precision)[0]
    _check_n(n)
    if type == 2:
        out = _flip(_dct2_raw(_signed(x), backend, precision))
        if norm == "ortho":
            out = out * _rows(_ortho_scale, n, out, True)[0]
        return out
    if type == 3:
        # transpose identity: DST-III(x)_j = (-1)^j DCT-III(rx)_j,
        # rx = x reversed
        if norm == "ortho":
            x = api._as_real(x)
            x = x * _rows(_ortho_in, n, x, True)[0]
        return _signed(_dct3_raw(_flip(x), backend, precision))
    raise ValueError(f"dst type {type} not supported (types 1-4)")


def idst(x: torch.Tensor, type: int = 2, norm: str | None = None,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """Inverse DST (scipy.fft.idst round-trip semantics)."""
    n = x.shape[-1]
    if type == 1:
        out, denom = _type1(x, True, norm, backend, precision)
        return out / denom if denom != 1.0 else out
    if type == 4:
        out, denom = _type4(x, True, norm, backend, precision)
        return out / denom if denom != 1.0 else out
    _check_n(n)
    if type == 2:
        if norm == "ortho":
            return dst(x, type=3, norm="ortho", backend=backend,
                       precision=precision)
        return _signed(_dct3_raw(_flip(x), backend, precision)) / (2.0 * n)
    if type == 3:
        if norm == "ortho":
            return dst(x, type=2, norm="ortho", backend=backend,
                       precision=precision)
        return _flip(_dct2_raw(_signed(x), backend, precision)) / (2.0 * n)
    raise ValueError(f"idst type {type} not supported (types 1-4)")


# ---------------------------------------------------------------------------
# N-D transforms (scipy.fft.dctn et al.): separable 1-D passes
# ---------------------------------------------------------------------------


def _apply_axes(x, axes, fn):
    for ax in _norm_axes(x.dim(), axes):
        x = _apply_last(x, ax, fn)
    return x


def dctn(x: torch.Tensor, type: int = 2, axes=None,
         norm: str | None = None, backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """N-D DCT over ``axes`` (default all; scipy.fft.dctn) as separable
    1-D passes, each one kernel launch."""
    return _apply_axes(x, axes, lambda v: dct(
        v, type=type, norm=norm, backend=backend, precision=precision))


def idctn(x: torch.Tensor, type: int = 2, axes=None,
          norm: str | None = None, backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """N-D inverse DCT (scipy.fft.idctn)."""
    return _apply_axes(x, axes, lambda v: idct(
        v, type=type, norm=norm, backend=backend, precision=precision))


def dstn(x: torch.Tensor, type: int = 2, axes=None,
         norm: str | None = None, backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """N-D DST over ``axes`` (scipy.fft.dstn)."""
    return _apply_axes(x, axes, lambda v: dst(
        v, type=type, norm=norm, backend=backend, precision=precision))


def idstn(x: torch.Tensor, type: int = 2, axes=None,
          norm: str | None = None, backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """N-D inverse DST (scipy.fft.idstn)."""
    return _apply_axes(x, axes, lambda v: idst(
        v, type=type, norm=norm, backend=backend, precision=precision))
