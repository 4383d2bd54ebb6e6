"""Fused spectral convolution: the Hopper kernels' wrappers and their plain
versions.

Counterpart of ``smfft_tpu/ops/convolve.py``.  Two hand-written CUDA
kernels (``csrc/conv.cu``) run the forward transform, the product with a
frequency response and the inverse transform of every row in one pass over
device memory:

  * :func:`launch_conv` — complex rows (B, N), N = 32..16384, interleaved
    complex64 or planar fp32, against m natural-order responses (m, N):
    ``y[j] = ifft(fft(x) * H[j])`` (numpy normalization), (m, B, N);
  * :func:`launch_conv_real` — real rows (B, n), n = 256..16384, against m
    rfft-style responses (m, n/2 + 1): ``y[j] = irfft(rfft(x) * H[j])``,
    (m, B, n).  The imaginary parts of H[0] and H[n/2] are ignored (zero
    for a real filter), as in the JAX package;
  * :func:`launch_conv_plane` — the complex bank's plane form, which
    replaces no TPU kernel: spectra (T, L) framed by overlap-save in the
    kernel's prologue, |y|^2 of each segment's valid part stored by its
    epilogue as the float32 (T, m, L) plane (``accel.accel_plane``).

m = 1 is the single form (the JAX package's ``_build_conv`` /
``_build_conv_real``), m > 1 the filter bank (``_build_conv_bank`` /
``_build_conv_real_bank``), whose forward transform runs once per row.

The TPU kernels keep the spectrum in revblock order and re-index H to
match (``freq_to_revblock``); the Hopper kernels (on the core of
``csrc/hcore.cuh``) hold it in natural order, so H is passed as given,
with the inverse's 1/N (1/L for real rows) folded in on the host in the
tier's precision (a power of two: exact).  m = 1 and m > 1 launch their
own instantiations of each kernel.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version (:func:`conv_plain`,
:func:`conv_real_plain`: ``c2c_plain`` forward, product, ``c2c_plain``
inverse; ``r2c_plain``, packed product, ``c2r_plain``), which never calls
``torch.fft``.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import params as P
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R


def check_real_size(n: int) -> None:
    """The real convolution's sizes: the real sizes from 256 up."""
    if n < 256 or n not in P.SUPPORTED_REAL_SIZES:
        raise ValueError(
            f"Error wrong FFT length! real convolve supports n in "
            f"{[s for s in P.SUPPORTED_REAL_SIZES if s >= 256]}, got {n}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def conv_plain(xr: torch.Tensor, xi: torch.Tensor, hr: torch.Tensor,
               hi: torch.Tensor, exact: bool = False):
    """:func:`launch_conv`'s function in plain PyTorch: planar rows (B, n)
    against response planes (m, n) with 1/n already folded in -> planar
    (m, B, n), at the tier's precision (``c2c.at_tier``)."""
    def run(xr, xi, hr, hi):
        fr, fi = C.c2c_plain(xr, xi)
        hr, hi = hr[:, None], hi[:, None]
        gr, gi = fr * hr - fi * hi, fr * hi + fi * hr
        m, b, n = gr.shape
        o_r, o_i = C.c2c_plain(gr.reshape(m * b, n), gi.reshape(m * b, n),
                               inverse=True)
        return o_r.reshape(m, b, n), o_i.reshape(m, b, n)
    return C.at_tier(run, exact, xr, xi, hr, hi)


def conv_real_plain(x: torch.Tensor, hr: torch.Tensor, hi: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """:func:`launch_conv_real`'s function in plain PyTorch: real rows
    (B, n) against packed half responses (m, n/2) (slot 0 = (Re H[0],
    Re H[n/2]), 1/(n/2) folded in) -> real (m, B, n)."""
    def run(x, hr, hi):
        n = x.shape[-1]
        xr, xi = R.r2c_plain(x, "planar")
        xr, xi, hr, hi = xr[None], xi[None], hr[:, None], hi[:, None]
        gr, gi = xr * hr - xi * hi, xr * hi + xi * hr
        # slot 0 = (DC, Nyquist): two real products
        gr = torch.cat([xr[..., :1] * hr[..., :1], gr[..., 1:]], dim=-1)
        gi = torch.cat([xi[..., :1] * hi[..., :1], gi[..., 1:]], dim=-1)
        m, b, L = gr.shape
        y = R.c2r_plain(gr.reshape(m * b, L), gi.reshape(m * b, L), n=n)
        return y.reshape(m, b, n)
    return C.at_tier(run, exact, x, hr, hi)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def device_response(h: torch.Tensor, scale: float, exact: bool,
                    device: torch.device) -> torch.Tensor:
    """A kernel's response operand: complex (m, w) times ``scale``, as
    complex64, or complex128 for the "exact" tier, contiguous on
    ``device``."""
    dtype = torch.complex128 if exact else torch.complex64
    return (h.to(device=device, dtype=dtype) * scale).contiguous()


def _check_response(h: torch.Tensor, x: torch.Tensor, width: int,
                    exact: bool) -> int:
    want = torch.complex128 if exact else torch.complex64
    if h.dim() != 2 or h.shape[1] != width or h.shape[0] < 1:
        raise ValueError(f"h must be (m, {width}), got {tuple(h.shape)}")
    if h.dtype != want or h.device != x.device or not h.is_contiguous():
        raise ValueError(f"h must be contiguous {want} on {x.device}")
    return h.shape[0]


def launch_conv(x: torch.Tensor, xi: torch.Tensor | None = None, *,
                h: torch.Tensor, exact: bool = False):
    """Launch ``conv_kernel`` of ``csrc/conv.cu`` on the current CUDA
    stream.

    ``x`` complex64 (B, n) -> complex64 (m, B, n); or ``x, xi`` planar
    float32 (B, n) -> planar pair (m, B, n).  ``h``: (m, n) responses from
    :func:`device_response` (1/n folded in).
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if x.dim() != 2:
            raise ValueError(f"x must be (batch, n), got {tuple(x.shape)}")
        b, n = x.shape
        m = _check_response(h, x, n, exact)
        a = sp and _T.now()
        _cuda.check_rows(x, xi)
        C.check_size(n)
        out, ptrs = C.outputs(x, xi, (m,))
        t = sp and _T.now()
        # the inverse core reads the forward table conjugated: no inverse
        # table (the entry point's tw_i is not read)
        tw_f = C.device_twiddles(n, False, bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.CONV, x.get_device(),
                     ("conv kernel launch (n={}, batch={}, m={})", n, b, m),
                     *ptrs, int(xi is None), b, n, m, h.data_ptr(),
                     tw_f.data_ptr(), None, int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:conv",
                        "interleaved" if xi is None else "planar", exact, b, n)
    return out


def launch_conv_real(x: torch.Tensor, *, h: torch.Tensor,
                     exact: bool = False) -> torch.Tensor:
    """Launch ``conv_real_kernel`` of ``csrc/conv.cu`` on the current CUDA
    stream: real float32 (B, n), n = 256..16384, contiguous and 8-byte
    aligned, against packed half responses ``h`` (m, n/2) from
    :func:`device_response` (slot 0 = (Re H[0], Re H[n/2]), 1/(n/2)
    folded in) -> float32 (m, B, n)."""
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if x.dim() != 2:
            raise ValueError(f"x must be (batch, n), got {tuple(x.shape)}")
        b, n = x.shape
        check_real_size(n)
        _cuda.check_rows(x, dtype=torch.float32)
        m = _check_response(h, x, n // 2, exact)
        a = sp and _T.now()
        out = torch.empty((m, b, n), device=x.device)
        t = sp and _T.now()
        tw_f = C.device_twiddles(n // 2, False, bool(exact), x.device)
        wn = R.split_table(n, bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.CONV_REAL, x.get_device(),
                     ("conv_real kernel launch (n={}, batch={}, m={})", n, b,
                      m),
                     x.data_ptr(), out.data_ptr(), b, n, m, h.data_ptr(),
                     tw_f.data_ptr(), None, wn.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:conv_real", "real",
                        exact, b, n)
    return out


def launch_conv_plane(x: torch.Tensor, *, h: torch.Tensor, k: int,
                      exact: bool = False) -> torch.Tensor:
    """Launch ``conv_plane_kernel`` of ``csrc/conv.cu`` on the current CUDA
    stream: spectra ``x`` complex64 (T, L) against m natural-order
    responses ``h`` (m, n) of ``k``-tap filters, 1 <= k < n, n =
    256..16384, complex64 (complex128 for "exact"), unscaled: the kernel
    multiplies each segment's points by 1/n -> float32 (T, m, L): |y|^2 of output
    (k - 1)//2 + b, b < L, of each row's linear convolution with each
    filter (x zero beyond both ends), by overlap-save in segments of n
    points, read from ``x`` in place.  The CPU path has no plain
    version of its own: ``accel._plane`` composes the framing,
    :func:`conv_plain`, the crop and the power there."""
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if x.dim() != 2 or x.dtype != torch.complex64:
            raise ValueError(f"x must be complex64 (trials, bins), got "
                             f"{tuple(x.shape)} {x.dtype}")
        if h.dim() != 2:
            raise ValueError(f"h must be (m, n), got {tuple(h.shape)}")
        rows, bins = x.shape
        n = h.shape[1]
        if n < 256 or n not in P.SUPPORTED_C2C_SIZES:
            raise ValueError(f"h must be (m, n), n a C2C size from 256, got "
                             f"{tuple(h.shape)}")
        if not 1 <= k < n:
            raise ValueError(f"need 1 <= k < n, got k={k}, n={n}")
        m = _check_response(h, x, n, exact)
        b = rows * -(-bins // (n - k + 1))
        a = sp and _T.now()
        _cuda.check_rows(x)
        out = torch.empty((rows, m, bins), device=x.device)
        t = sp and _T.now()
        tw_f = C.device_twiddles(n, False, bool(exact), x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.CONV_PLANE, x.get_device(),
                     ("conv_plane kernel launch (n={}, trials={}, bins={}, "
                      "m={})", n, rows, bins, m),
                     x.data_ptr(), out.data_ptr(), rows, bins, n, k, m,
                     h.data_ptr(), tw_f.data_ptr(), int(exact))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:conv_plane", "plane",
                        exact, b, n)
    return out


# ---------------------------------------------------------------------------
# Device dispatch, the packed real response, and the JAX package's planar
# entry points.
# ---------------------------------------------------------------------------


def conv_rows(x: torch.Tensor, xi: torch.Tensor | None, h: torch.Tensor,
              exact: bool = False):
    """Complex (B, n) rows (one complex tensor, or a planar pair with
    ``xi``) against natural-order responses ``h`` complex (m, n) -> (m, B,
    n) in the same layout: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    n = x.shape[-1]
    if C.is_cpu(x):
        hs = h / n
        if xi is None:
            return torch.complex(*conv_plain(x.real, x.imag, hs.real,
                                             hs.imag, exact))
        return conv_plain(x, xi, hs.real, hs.imag, exact)
    return launch_conv(x, xi, h=device_response(h, 1.0 / n, exact, x.device),
                       exact=exact)


def pack_real_response(h: torch.Tensor) -> torch.Tensor:
    """rfft-style responses (m, L+1) -> the packed (m, L) form: slot 0 =
    Re H[0] + i Re H[L] (their imaginary parts are ignored), bins 1..L-1
    as given (``convolve._pack_real_response`` without the TPU's revblock
    step and before the 1/L)."""
    L = h.shape[-1] - 1
    slot0 = torch.complex(h.real[..., :1], h.real[..., L:])
    return torch.cat([slot0, h[..., 1:L]], dim=-1)


def conv_real_rows(x: torch.Tensor, h: torch.Tensor,
                   exact: bool = False) -> torch.Tensor:
    """Real (B, n) rows against rfft-style responses ``h`` complex (m,
    n/2 + 1) -> real (m, B, n), by device as :func:`conv_rows`."""
    n = x.shape[-1]
    pk = pack_real_response(h)
    if C.is_cpu(x):
        pk = pk / (n // 2)
        return conv_real_plain(x, pk.real, pk.imag, exact)
    return launch_conv_real(
        x, h=device_response(pk, 2.0 / n, exact, x.device), exact=exact)


def _planar_response(hr, hi, ref: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.as_tensor(hr, dtype=torch.float32),
                         torch.as_tensor(hi, dtype=torch.float32)).to(
                             ref.device)


def convolve_bank_planar(vr: torch.Tensor, vi: torch.Tensor, hr, hi,
                         n: int, exact: bool = False):
    """Planar rows (rows, max(n, 128)) (128/n transforms a row below 128,
    as ``fft_planar``) against m natural-order responses ``hr, hi`` (m, n)
    -> planar (m, rows, max(n, 128)), numpy normalization
    (``convolve.convolve_bank_planar``)."""
    xr, xi = C.planar_rows(vr, vi, n)
    h = _planar_response(hr, hi, xr)
    o_r, o_i = conv_rows(xr, xi, h.reshape(-1, n), exact)
    shape = (o_r.shape[0],) + tuple(vr.shape)
    return o_r.reshape(shape), o_i.reshape(shape)


def convolve_planar(vr: torch.Tensor, vi: torch.Tensor, hr, hi, n: int,
                    exact: bool = False):
    """Planar rows against one natural-order response ``hr, hi`` (n,) ->
    planar rows ``ifft(fft(x) * H)`` (``convolve.convolve_planar``)."""
    o_r, o_i = convolve_bank_planar(vr, vi, torch.as_tensor(hr)[None],
                                    torch.as_tensor(hi)[None], n, exact)
    return o_r[0], o_i[0]


def convolve_real_bank_planar(x: torch.Tensor, hr, hi, n: int,
                              exact: bool = False) -> torch.Tensor:
    """Real rows (B, n), n >= 256, against m rfft-style responses ``hr,
    hi`` (m, n/2 + 1) -> real (m, B, n)
    (``convolve.convolve_real_bank_planar``)."""
    check_real_size(n)
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"expected real rows (B, {n}), got "
                         f"{tuple(x.shape)}")
    x = _cuda.contiguous(x.to(torch.float32))
    h = _planar_response(hr, hi, x)
    return conv_real_rows(x, h.reshape(-1, n // 2 + 1), exact)


def convolve_real_planar(x: torch.Tensor, hr, hi, n: int,
                         exact: bool = False) -> torch.Tensor:
    """Real rows (B, n) against one rfft-style response ``hr, hi``
    (n/2 + 1,) -> real (B, n) (``convolve.convolve_real_planar``)."""
    return convolve_real_bank_planar(x, torch.as_tensor(hr)[None],
                                     torch.as_tensor(hi)[None], n, exact)[0]
