"""Batched C2C FFT op: the Hopper kernel's wrapper and its plain version.

Counterpart of ``smfft_tpu/ops/pallas_c2c.py`` (kernel A, kernel B, the
fused scale) and of ``smfft_tpu/ops/pencil.py::fft_pencil_planar``: one
hand-written CUDA kernel (``csrc/c2c.cu``) computes

    y = scale * DFT_N^{+-}(x),   N in 32..16384, batched over rows,

with the input and the output each in natural order or revblock order.
Revblock is the layout of the JAX package's pallas backend: position
``k2*128 + k1`` holds element ``k1*C + k2``, ``C = N/128``; for N <= 128
it is natural order.

Dispatch is by the tensor's device and nothing else:
  * a CUDA tensor launches the kernel (:func:`launch`) or raises;
  * a CPU tensor runs the plain PyTorch version (:func:`c2c_plain`).
There is no fallback from one to the other.

The plain version is the two-factor split B1 computes (``n = n1 + 128*n2``:
DFT_C over n2, twiddle W_N^{k2*n1}, DFT_128 over n1, which lands revblock)
and its mirror for revblock input, built from :func:`tables`, which are
bit-identical to the JAX package's ``pallas_c2c._tables``.  It never calls
``torch.fft``; that is the oracle the tests hold both versions against.

The TPU path pads row batches to the 8-sublane granule; the kernel masks
the ragged tail of the batch itself, so no padding pass exists here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from smfft_tpu_torch import params as P

LANES = 128


# ---------------------------------------------------------------------------
# Constant tables (float64-accurate, fp32-rounded).
# ---------------------------------------------------------------------------


def _dftmat(m: int, sign: float):
    a = np.arange(m, dtype=np.float64)
    ang = sign * 2.0 * np.pi * np.outer(a, a % m) / m
    return np.cos(ang), np.sin(ang)


@lru_cache(maxsize=None)
def _tables64(n: int, inverse: bool):
    sign = +1.0 if inverse else -1.0
    c = max(1, n // LANES)
    if n >= LANES:
        g_re, g_im = _dftmat(LANES, sign)
    else:
        p = LANES // n
        dr, di = _dftmat(n, sign)
        g_re, g_im = np.kron(np.eye(p), dr), np.kron(np.eye(p), di)
    if c > 1:
        f_re, f_im = _dftmat(c, sign)
        k2 = np.arange(c, dtype=np.float64)[:, None]
        n1 = np.arange(LANES, dtype=np.float64)[None, :]
        tang = sign * 2.0 * np.pi * k2 * n1 / n
        t_re, t_im = np.cos(tang), np.sin(tang)
    else:
        f_re = f_im = np.zeros((1, 1))
        t_re = t_im = np.zeros((1, 1))
    return f_re, f_im, t_re, t_im, g_re, g_im


def tables(n: int, inverse: bool):
    """(f_re, f_im, t_re, t_im, g_re, g_im) fp32 for the (C, 128) split of
    n: F = DFT_C, t[k2, n1] = W_N^{k2*n1}, G = DFT_128 (kron-packed
    DFT_n blocks for n < 128).  Computed in float64 and rounded once, as
    the JAX package computes them."""
    return tuple(m.astype(np.float32) for m in _tables64(n, inverse))


def _torch_tables(n: int, inverse: bool, dtype: torch.dtype,
                  device: torch.device):
    f64 = _tables64(n, inverse)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return [torch.from_numpy(m.astype(np_dtype)).to(device) for m in f64]


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------


def _cmm(ar, ai, br, bi):
    """Complex matmul on planar pairs: (ar + i ai) @ (br + i bi)."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _to_revblock(y, c):
    """Natural rows (B, n) -> revblock rows."""
    b = y.shape[0]
    return y.reshape(b, LANES, c).transpose(1, 2).reshape(b, LANES * c)


def c2c_plain(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False,
              rev_in: bool = False, rev_out: bool = False,
              scale: float | None = None):
    """The kernel's function in plain PyTorch: planar (B, n) float32 or
    float64 pairs in, planar (B, n) pairs out, same layouts and scale."""
    b, n = xr.shape
    if scale is not None:
        xr, xi = xr * scale, xi * scale
    c = max(1, n // LANES)
    f_re, f_im, t_re, t_im, g_re, g_im = _torch_tables(
        n, inverse, xr.dtype, xr.device)
    if c == 1:
        # one small DFT per row: natural order in and out
        if n < LANES:
            g_re, g_im = g_re[:n, :n], g_im[:n, :n]
        return _cmm(xr, xi, g_re.T, g_im.T)
    xr, xi = xr.reshape(b, c, LANES), xi.reshape(b, c, LANES)
    if not rev_in:
        # kernel A: DFT_C over n2 -> k2, twiddle, DFT_128 over n1 -> k1;
        # rows land [k2, k1], which is revblock
        ar, ai = _cmm(f_re, f_im, xr, xi)
        ar, ai = ar * t_re - ai * t_im, ar * t_im + ai * t_re
        yr, yi = _cmm(ar, ai, g_re.T, g_im.T)
        if rev_out:
            return yr.reshape(b, n), yi.reshape(b, n)
        return (yr.transpose(1, 2).reshape(b, n),
                yi.transpose(1, 2).reshape(b, n))
    # kernel B (the mirror): rows hold [j2, j1]; DFT_128 over j1 -> m1,
    # twiddle W_N^{j2*m1}, DFT_C over j2 -> m2; rows land [m2, m1], natural
    sr, si = _cmm(xr, xi, g_re.T, g_im.T)
    sr, si = sr * t_re - si * t_im, sr * t_im + si * t_re
    yr, yi = _cmm(f_re, f_im, sr, si)
    yr, yi = yr.reshape(b, n), yi.reshape(b, n)
    if rev_out:
        return _to_revblock(yr, c), _to_revblock(yi, c)
    return yr, yi


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _device_twiddles(n: int, inverse: bool, device: torch.device):
    return torch.from_numpy(P.twiddle_table(n, inverse).copy()).to(device)


def _check_rows(t: torch.Tensor, name: str, dtype: torch.dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be (batch, n), got {tuple(t.shape)}")
    check_size(t.shape[-1])
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(x: torch.Tensor, xi: torch.Tensor | None = None, *,
           inverse: bool = False, rev_in: bool = False,
           rev_out: bool = False, scale: float | None = None):
    """Launch ``csrc/c2c.cu`` on the current CUDA stream.

    ``x`` complex64 (B, n) -> complex64 (B, n) (interleaved); or ``x, xi``
    planar float32 (B, n) -> planar pair.  Outputs are allocated with
    ``torch.empty``.  Each launch adds one to ``launch.count``.
    """
    from smfft_tpu_torch.ops import _cuda

    if xi is None:
        _check_rows(x, "x", torch.complex64)
        out = torch.empty_like(x)
        in_re, in_im = x.data_ptr(), None
        out_re, out_im = out.data_ptr(), None
        interleaved = 1
        if in_re % 8 or out_re % 8:
            raise ValueError("complex64 data must be 8-byte aligned")
    else:
        _check_rows(x, "xr", torch.float32)
        _check_rows(xi, "xi", torch.float32)
        if x.shape != xi.shape or x.device != xi.device:
            raise ValueError(f"planar pair differs: {tuple(x.shape)} on "
                             f"{x.device} vs {tuple(xi.shape)} on "
                             f"{xi.device}")
        out = (torch.empty_like(x), torch.empty_like(xi))
        in_re, in_im = x.data_ptr(), xi.data_ptr()
        out_re, out_im = out[0].data_ptr(), out[1].data_ptr()
        interleaved = 0
    b, n = x.shape
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        tw = _device_twiddles(n, bool(inverse), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.smfft_c2c(in_re, in_im, out_re, out_im, interleaved, b, n,
                            int(inverse), int(rev_in), int(rev_out),
                            1.0 if scale is None else float(scale),
                            tw.data_ptr(), stream)
    _cuda.check(err, f"c2c kernel launch (n={n}, batch={b})")
    launch.count += 1
    return out


launch.count = 0


# ---------------------------------------------------------------------------
# Device dispatch, layouts and the packing rule.
# ---------------------------------------------------------------------------


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_size(n: int) -> None:
    """The reference's static size switch."""
    if n not in P.SUPPORTED_C2C_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}; supported: "
                         f"{P.SUPPORTED_C2C_SIZES}")


def check_pack(batch: int, n: int) -> None:
    """The reference's batch rule: N < 128 packs 128/N transforms per
    128-wide row, so the batch must be a multiple of 128/N."""
    pack = max(1, LANES // n)
    if batch % pack:
        raise ValueError(
            f"n={n} packs {pack} transforms per row: batch must be a "
            f"multiple of {pack} (reference rule, FFT-GPU-32bit.cu:835-836)")


def fft_planar(vr: torch.Tensor, vi: torch.Tensor, n: int,
               inverse: bool = False, rev_in: bool = False,
               ordered: bool = False, scale: float | None = None):
    """Planar batched FFT on the JAX package's row layout.

    vr, vi: float32 (rows, max(n, 128)); rows pack 128/n transforms when
    n < 128.  ``rev_in=False`` is kernel A (natural in; revblock out, or
    natural when ``ordered``); ``rev_in=True`` is kernel B (revblock in,
    natural out).  ``scale`` multiplies the input inside the kernel.
    """
    check_size(n)
    row = max(n, LANES)
    if vr.shape != vi.shape or vr.dim() != 2 or vr.shape[1] != row:
        raise ValueError(f"expected planar rows (rows, {row}), got "
                         f"{tuple(vr.shape)} and {tuple(vi.shape)}")
    rows = vr.shape[0]
    b = rows * row // n
    kw = dict(inverse=inverse, rev_in=rev_in,
              rev_out=not (ordered or rev_in), scale=scale)
    xr, xi = vr.reshape(b, n), vi.reshape(b, n)
    o_r, o_i = (c2c_plain(xr, xi, **kw) if _is_cpu(xr)
                else launch(xr, xi, **kw))
    return o_r.reshape(rows, row), o_i.reshape(rows, row)


def fft_complex(x: torch.Tensor, inverse: bool = False,
                ordered: bool = True, rev_in: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """Complex (..., n) batched FFT with the packing rule applied.

    ``rev_in=False``: natural in, natural (``ordered``) or revblock out —
    ``pallas_c2c.fft_pallas``.  ``rev_in=True``: revblock in, natural out
    — ``pallas_c2c.ifft_pallas_rev``.
    """
    n = x.shape[-1]
    check_size(n)
    batch_shape = x.shape[:-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    check_pack(b, n)
    kw = dict(inverse=inverse, rev_in=rev_in,
              rev_out=not (ordered or rev_in), scale=scale)
    x = x.reshape(b, n).resolve_conj().contiguous()
    if _is_cpu(x):
        y = torch.complex(*c2c_plain(x.real, x.imag, **kw))
    else:
        y = launch(x, **kw)  # interleaved: no conversion pass
    return y.reshape(batch_shape + (n,))
