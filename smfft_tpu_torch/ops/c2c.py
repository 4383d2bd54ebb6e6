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

import ctypes
from functools import lru_cache

import numpy as np
import torch

from smfft_tpu_torch import params as P
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops._cuda import C2C_RUN as _RUN, launch as _launch

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
def device_twiddles(n: int, inverse: bool, exact: bool,
                    device: torch.device) -> torch.Tensor:
    """The kernel's W_N^m table on the device: float32, or float64 for the
    "exact" tier.  Made once per size, direction, tier and device (the
    cache), so no launch copies a table from the host."""
    tab = P.twiddle_table(n, inverse, "float64" if exact else "float32")
    return torch.from_numpy(tab.copy()).to(device)


#: the most plans the cache holds; past it the least recently used goes
PLAN_SLOTS = 64
# launch plans by key, least recently used first: a hit pops its plan and
# sets it again (two steps, each atomic), so it needs no lock; two threads
# that miss one key together may both build it, and either plan serves
_plans: dict = {}


class _Plan:
    """What every launch of one key repeats, worked out once: the address
    of the constants ``smfft_c2c_prepare`` filled (the instantiation, the
    layout, the direction and orders, the twiddle table's pointer), the
    storage of both, and the device's index."""

    __slots__ = ("addr", "consts", "twiddles", "index")

    def __init__(self, consts, twiddles, index):
        self.consts, self.twiddles, self.index = consts, twiddles, index
        self.addr = ctypes.addressof(consts)


def _build_plan(key: tuple, x: torch.Tensor,
                xi: torch.Tensor | None) -> _Plan:
    """A key's plan: the input's checks, the device's twiddle table and the
    library's constants, prepared on the device (which lets the
    instantiation take its shared memory there).  Adds one to
    ``launch.plans``."""
    _cuda.check_rows(x, xi)
    n, _, interleaved, index, inverse, rev_in, rev_out, exact = key
    check_size(n)
    tw = device_twiddles(n, bool(inverse), bool(exact), x.device)
    size = _cuda.bound(_cuda.C2C_PLAN_BYTES)()
    consts = (ctypes.c_uint64 * -(-size // 8))()
    _cuda.launch(_cuda.C2C_PREPARE, index, ("c2c plan (n={})", n),
                 ctypes.addressof(consts), n, int(exact), int(interleaved),
                 int(inverse), int(rev_in), int(rev_out), tw.data_ptr(),
                 stream=False)
    # list() reads the keys in one step, so another thread's hit (a pop
    # and a set) cannot change the dict under an iterator
    keys = list(_plans)
    for old in keys[:max(0, len(keys) + 1 - PLAN_SLOTS)]:
        _plans.pop(old, None)
    launch.plans += 1
    return _Plan(consts, tw, index)


def launch(x: torch.Tensor, xi: torch.Tensor | None = None, *,
           inverse: bool = False, rev_in: bool = False,
           rev_out: bool = False, scale: float | None = None,
           exact: bool = False):
    """Launch ``csrc/c2c.cu`` on the current CUDA stream.

    ``x`` complex64 (B, n) -> complex64 (B, n) (interleaved); or ``x, xi``
    planar float32 (B, n) -> planar pair.  ``exact`` runs the fp64
    arithmetic instantiation (the "exact" tier).  Outputs are allocated
    with ``torch.empty_like``.

    The launch plan of the key (n, dtype, layout, device, ``inverse``,
    ``rev_in``, ``rev_out``, ``exact``) is built at its first launch and
    cached (:data:`PLAN_SLOTS`); a later launch checks only what the key
    cannot hold (shape, contiguity, conjugation, alignment), allocates and
    runs the plan through ``_cuda.launch``.  The batch and ``scale``
    travel with each launch.  Each plan built adds one to
    ``launch.plans``.
    """
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        a = sp
        if x.dim() != 2 or x.is_conj() or not x.is_contiguous() or (
                x.data_ptr() % 8 if xi is None else
                xi.dtype != x.dtype or xi.shape != x.shape
                or xi.get_device() != x.get_device()
                or not xi.is_contiguous()):
            _cuda.check_rows(x, xi)
        b, n = x.shape
        if xi is None:
            out = torch.empty_like(x)
            ptrs = (x.data_ptr(), None, out.data_ptr(), None)
        else:
            out = (torch.empty_like(x), torch.empty_like(xi))
            ptrs = (x.data_ptr(), xi.data_ptr(), out[0].data_ptr(),
                    out[1].data_ptr())
        t = sp and _T.now()
        key = (n, x.dtype, xi is None, x.get_device(), inverse, rev_in,
               rev_out, exact)
        plan = _plans.pop(key, None)
        if plan is None:
            plan = _build_plan(key, x, xi)
        _plans[key] = plan
        c = sp and _T.now()
        _launch(_RUN, plan.index, ("c2c kernel launch (n={}, batch={})", n, b),
                plan.addr, *ptrs, b, 1.0 if scale is None else float(scale))
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:c2c",
                        "interleaved" if xi is None else "planar", exact, b, n)
    return out


launch.plans = 0


def outputs(x: torch.Tensor, xi: torch.Tensor | None = None,
            lead: tuple[int, ...] = ()):
    """A kernel's output in its checked input's layout: complex ``x``
    alone, or the planar float32 pair ``x, xi``; shape ``lead + (B, n)``.
    Returns it and the (in_re, in_im, out_re, out_im) pointers."""
    shape = lead + tuple(x.shape)
    if xi is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        return out, (x.data_ptr(), None, out.data_ptr(), None)
    out = (torch.empty(shape, device=x.device),
           torch.empty(shape, device=x.device))
    return out, (x.data_ptr(), xi.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr())


# ---------------------------------------------------------------------------
# Device dispatch, layouts and the packing rule.
# ---------------------------------------------------------------------------


def at_tier(fn, exact: bool, *tensors):
    """fn(*tensors) at the tier's precision: "exact" computes float32 /
    complex64 input in float64 and rounds the result once, as its kernels
    do; otherwise the tensors' own precision."""
    if not exact or tensors[0].dtype not in (torch.float32,
                                             torch.complex64):
        return fn(*tensors)
    out = fn(*(t.to(torch.complex128 if t.is_complex() else torch.float64)
               for t in tensors))
    if isinstance(out, tuple):
        return tuple(o.to(torch.float32) for o in out)
    return out.to(torch.complex64 if out.is_complex() else torch.float32)


def plain(xr: torch.Tensor, xi: torch.Tensor, exact: bool = False, **kw):
    """:func:`c2c_plain` at the tier's precision (:func:`at_tier`)."""
    return at_tier(lambda a, b: c2c_plain(a, b, **kw), exact, xr, xi)


def is_cpu(t: torch.Tensor) -> bool:
    """Dispatch by device: True for a CPU tensor (the plain version), False
    for a CUDA tensor (the kernel); anything else raises."""
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


def planar_rows(vr: torch.Tensor, vi: torch.Tensor, n: int):
    """The JAX package's planar rows (rows, max(n, 128)), 128/n transforms
    a row below n = 128 -> one (B, n) row per transform."""
    check_size(n)
    row = max(n, LANES)
    if vr.shape != vi.shape or vr.dim() != 2 or vr.shape[1] != row:
        raise ValueError(f"expected planar rows (rows, {row}), got "
                         f"{tuple(vr.shape)} and {tuple(vi.shape)}")
    b = vr.shape[0] * row // n
    return vr.reshape(b, n), vi.reshape(b, n)


def fft_planar(vr: torch.Tensor, vi: torch.Tensor, n: int,
               inverse: bool = False, rev_in: bool = False,
               ordered: bool = False, scale: float | None = None,
               exact: bool = False, multiple_iters: int = 0):
    """Planar batched FFT on the JAX package's row layout.

    vr, vi: float32 (rows, max(n, 128)); rows pack 128/n transforms when
    n < 128.  ``rev_in=False`` is kernel A (natural in; revblock out, or
    natural when ``ordered``); ``rev_in=True`` is kernel B (revblock in,
    natural out).  ``scale`` multiplies the input inside the kernel.
    ``multiple_iters`` > 0 re-applies kernel A that many times, times
    1/sqrt(n), before the final transform, with the data held on chip
    (the reuse loop, :func:`~smfft_tpu_torch.ops.multiple.
    fft_planar_multiple`).
    """
    xr, xi = planar_rows(vr, vi, n)
    rows, row = vr.shape
    if multiple_iters:
        from smfft_tpu_torch.ops import multiple
        o_r, o_i = multiple.fft_planar_multiple(
            xr, xi, n, multiple_iters, inverse=inverse, rev_in=rev_in,
            ordered=ordered, scale=scale, exact=exact)
        return o_r.reshape(rows, row), o_i.reshape(rows, row)
    kw = dict(inverse=inverse, rev_in=rev_in,
              rev_out=not (ordered or rev_in), scale=scale, exact=exact)
    o_r, o_i = plain(xr, xi, **kw) if is_cpu(xr) else launch(xr, xi, **kw)
    return o_r.reshape(rows, row), o_i.reshape(rows, row)


def fft_complex(x: torch.Tensor, inverse: bool = False,
                ordered: bool = True, rev_in: bool = False,
                scale: float | None = None,
                exact: bool = False) -> torch.Tensor:
    """Complex (..., n) batched FFT with the packing rule applied.

    ``rev_in=False``: natural in, natural (``ordered``) or revblock out —
    ``pallas_c2c.fft_pallas``.  ``rev_in=True``: revblock in, natural out
    — ``pallas_c2c.ifft_pallas_rev``.
    """
    shape = x.shape
    n = shape[-1]
    check_size(n)
    b = x.numel() // n
    check_pack(b, n)
    if x.is_conj() or not x.is_contiguous():
        x = x.resolve_conj().contiguous()
    rows = x if x.dim() == 2 else x.view(b, n)
    rev_out = not (ordered or rev_in)
    if is_cpu(x):
        y = torch.complex(*plain(rows.real, rows.imag, inverse=inverse,
                                 rev_in=rev_in, rev_out=rev_out, scale=scale,
                                 exact=exact))
    else:
        # interleaved: no conversion pass
        y = launch(rows, inverse=inverse, rev_in=rev_in, rev_out=rev_out,
                   scale=scale, exact=exact)
    return y if rows is x else y.view(shape)
