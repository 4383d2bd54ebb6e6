"""N-dimensional transforms and numpy-compatible spectral helpers.

The counterpart of ``smfft_tpu/ndim.py``, with the same names, signatures
and errors.  An N-D transform is a sequence of batched 1-D transforms, one
an axis.  The last axis is one launch of a row kernel (``csrc/c2c.cu`` for
C2C, ``csrc/real.cu`` / ``csrc/c2r.cu`` for the real axis).

A C2C over another axis takes the column route where it can
(:func:`_columns_fit`: ``fft2``, ``ifft2``, ``fftn``, ``ifftn`` in natural
order, complex64 on the card, every leading axis at a power-of-two stride
K, the product of the axes after it): :class:`_ColumnC2C` runs one or two
launches of ``csrc/fourstep.cu``'s pass kernel that read and write the
axis at its stride (``ops/fourstep_fused.run_columns``), the last axis
first, so the leading axes' first passes run in place on the row kernel's
result.  Where an axis takes two passes (M > 2048) they are one launch in
fp32 when a slab of columns fits the stride, the second reading the
first's output from L2: a 2-D C2C FFT of a 16384^2 grid is then one row
launch and one column launch, two sweeps of the grid, no copy.

Elsewhere (``ordered=False``, a stride that is not a power of two, the
C2C axes of ``rfft2`` / ``irfft2`` / ``rfftn`` / ``irfftn``, whose
half-spectrum stride is n/2 + 1, and ``dct.py``) a pass over a leading
axis first moves that axis last with ``torch.transpose``, and the op layer
copies the transposed view before the launch (``ops/_cuda.contiguous``,
counted in ``copied_bytes``): a 2-D C2C FFT there costs two row launches
and two copies.

Each N-D transform records a root span ``call:<name>`` (``trace.py``) that
holds the row calls of its passes (``call:fft``, ``call:ifft``,
``call:rfft``, ``call:irfft``; a column route's is ``call:fft`` /
``call:ifft`` with ``n`` the axis's length, around its ``op:column_c2c``),
so the time between them is the N-D glue.

Every axis length must be a supported 1-D size (the same "Error wrong FFT
length!" contract as the 1-D API).  Layouts and normalization follow
numpy.fft (``rfft2`` / ``irfft2`` transform the last axis with the real
kernels and the remaining axes with C2C).  As in :mod:`api`, the inverses
take ``norm="backward"`` (numpy) or ``None`` (the raw inverse) and raise on
any other norm; ``hfft`` / ``ihfft`` take numpy's three norms.

``fftshift`` / ``ifftshift`` are ``torch.roll``; ``fftfreq`` / ``rfftfreq``
are computed in float64 on the host and returned as float32 CPU tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from smfft_tpu_torch import api
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES


def _call(name: str, real_out: bool = False):
    """Record the decorated transform as the root span ``call:<name>``
    with its input's ``rows`` and its ``n``: the input's last dim, or with
    ``real_out`` the real output's (the ``n`` argument, else
    2 * (bins - 1)), as ``call:irfft`` records it."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(x, *args, **kwargs):
            t = _T.on and _T.now()
            try:
                return fn(x, *args, **kwargs)
            finally:
                if t:
                    n = None
                    if real_out:
                        n = (args[0] if args else kwargs.get("n")) or 2 * (
                            x.shape[-1] - 1)
                    _T.record(t, f"call:{name}", x, n)
        return call
    return wrap


def _norm_axes(ndim: int, axes) -> tuple[int, ...]:
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    out = tuple(a % ndim for a in axes)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in axes={axes}")
    return out


def _apply_last(x: torch.Tensor, ax: int, fn) -> torch.Tensor:
    """Move axis ``ax`` last, apply ``fn``, move back (no moves when
    ``ax`` already is the last axis)."""
    nd = x.dim()
    if ax == nd - 1:
        return fn(x)
    return torch.transpose(fn(torch.transpose(x, ax, -1)), ax, -1)


class _ColumnC2C(torch.autograd.Function):
    """Ordered C2C over the leading axis ``ax`` of a complex tensor by the
    column passes (``ops/fourstep_fused.run_columns``); the output is
    contiguous.  As for ``api._OrderedC2C``, the backward of a transform
    of scale s is the raw transform of the opposite direction at the same
    scale.  ``own``: nothing else holds ``x`` and no gradient flows to it,
    so the first pass may overwrite it."""

    @staticmethod
    def forward(ctx, x, ax: int, inverse: bool, scale, exact: bool,
                own: bool):
        ctx.args = (ax, inverse, scale, exact)
        t = _T.on and _T.now()
        try:
            m = x.shape[ax]
            k = math.prod(x.shape[ax + 1:])
            x = _cuda.contiguous(x)
            y = FF.run_columns(x.view(-1, m * k), m, k, inverse=inverse,
                               scale=1.0 if scale is None else scale,
                               exact=exact, own=own)
            return y.view(x.shape)
        finally:
            if t:
                _T.record(t, "op:column_c2c")

    @staticmethod
    def backward(ctx, g):
        ax, inverse, scale, exact = ctx.args
        return (_ColumnC2C.apply(g, ax, not inverse, scale, exact, False),
                None, None, None, None, None)


def _columns_fit(x: torch.Tensor, lead, ordered: bool, backend) -> bool:
    """Whether the column route takes the leading axes ``lead`` of ``x``:
    the "auto" backend in natural order, an input that is complex64 once
    promoted (complex128 too on the CPU) and not empty, and at every
    leading axis a supported C2C length m whose packing rule holds
    (``c2c.check_pack``) and a power-of-two stride.  Else the row calls
    over transposed views, which raise what they raise."""
    if not (lead and ordered and backend == "auto" and x.numel()):
        return False
    if (x.is_complex() and x.device.type != "cpu"
            and x.dtype != torch.complex64):
        return False
    for ax in lead:
        m, k = x.shape[ax], math.prod(x.shape[ax + 1:])
        if (m not in SUPPORTED_C2C_SIZES or k & (k - 1)
                or x.numel() // m % max(1, C.LANES // m)):
            return False
    return True


def _columns(x, ax, inverse, scale, exact, own):
    """The column route over axis ``ax``, recorded as the row call
    ``call:fft`` / ``call:ifft`` of that axis (``n`` its length)."""
    t = _T.on and _T.now()
    try:
        own = own and not (torch.is_grad_enabled() and x.requires_grad)
        return _ColumnC2C.apply(x, ax, inverse, scale, exact, own)
    finally:
        if t:
            _T.record(t, "call:ifft" if inverse else "call:fft",
                      x.movedim(ax, -1))


def _c2c_axes(x, axes, inverse, ordered, backend, precision, norm):
    """The C2C transform of ``x`` over ``axes``: by the column route
    where :func:`_columns_fit`, the last axis first by its row call, else
    one row call over each axis in turn, moved last."""
    if inverse:
        row = functools.partial(api.ifft, backend=backend,
                                precision=precision, norm=norm)
    else:
        row = functools.partial(api.fft, ordered=ordered, backend=backend,
                                precision=precision)
    last = x.dim() - 1
    lead = [ax for ax in axes if ax != last]
    if not _columns_fit(x, lead, ordered, backend):
        for ax in axes:
            x = _apply_last(x, ax, row)
        return x
    y = api._as_complex(x)
    own = y is not x
    if last in axes:
        y, own = row(y), True
    for ax in lead:
        scale = api._norm_scale(norm, x.shape[ax]) if inverse else None
        y = _columns(y, ax, inverse, scale, api._exact(precision), own)
        own = True
    return y


def _fftn(x, axes, ordered, backend, precision):
    axes = _norm_axes(x.dim(), axes)
    if not ordered and len(axes) > 1:
        raise ValueError("ordered=False requires a single transform axis")
    return _c2c_axes(x, axes, False, ordered, backend, precision, None)


def _ifftn(x, axes, backend, precision, norm):
    axes = _norm_axes(x.dim(), axes)
    return _c2c_axes(x, axes, True, True, backend, precision, norm)


@_call("fftn")
def fftn(x: torch.Tensor, axes=None, ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """N-D forward C2C FFT over ``axes`` (default: all axes), numpy
    ``fftn`` semantics.  Every transformed axis length must be a
    supported 1-D size.  ``ordered=False`` is only meaningful for a
    single transform axis (later passes need natural-order input)."""
    return _fftn(x, axes, ordered, backend, precision)


@_call("ifftn")
def ifftn(x: torch.Tensor, axes=None, backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> torch.Tensor:
    """N-D inverse C2C FFT over ``axes`` (numpy ``ifftn``: each axis
    divides by its length under ``norm="backward"``; ``norm=None`` is the
    raw inverse)."""
    return _ifftn(x, axes, backend, precision, norm)


@_call("fft2")
def fft2(x: torch.Tensor, axes=(-2, -1), ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """2-D forward C2C FFT (numpy ``fft2``)."""
    return _fftn(x, axes, ordered, backend, precision)


@_call("ifft2")
def ifft2(x: torch.Tensor, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> torch.Tensor:
    """2-D inverse C2C FFT (numpy ``ifft2``)."""
    return _ifftn(x, axes, backend, precision, norm)


def _check_real_last_axis(ndim: int, axes, fname: str):
    if axes[-1] != ndim - 1:
        raise ValueError(f"{fname} requires the last transform axis to "
                         f"be the last array axis (numpy applies the "
                         f"real transform there)")


def _rfftn(x, axes, backend, precision, fname):
    axes = _norm_axes(x.dim(), axes)
    _check_real_last_axis(x.dim(), axes, fname)
    x = api.rfft(x, backend=backend, precision=precision)
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.fft(
            v, backend=backend, precision=precision))
    return x


@_call("rfft2")
def rfft2(x: torch.Tensor, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """2-D R2C FFT (numpy ``rfft2``): real kernel over ``axes[-1]``
    (half-spectrum output), C2C over the remaining axes."""
    return _rfftn(x, axes, backend, precision, "rfft2")


@_call("rfftn")
def rfftn(x: torch.Tensor, axes=None, backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """N-D R2C FFT (numpy ``rfftn``): real kernel over the last given
    axis (half-spectrum output), C2C over the rest.  Default: all axes.
    The last transform axis must be the last array axis (where numpy
    applies the real transform)."""
    return _rfftn(x, axes, backend, precision, "rfftn")


@_call("irfftn", real_out=True)
def irfftn(x: torch.Tensor, n: int | None = None, axes=None,
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> torch.Tensor:
    """N-D C2R inverse FFT (numpy ``irfftn``), inverse of
    :func:`rfftn`."""
    _check_real_last_axis(x.dim(), _norm_axes(x.dim(), axes), "irfftn")
    return _irfftn(x, n, axes, backend, precision, norm)


def _fit_last(x: torch.Tensor, m: int) -> torch.Tensor:
    """numpy's n-parameter semantics: zero-pad or truncate the last axis
    to length m before transforming."""
    k = x.shape[-1]
    if k == m:
        return x
    if k > m:
        return x[..., :m]
    return F.pad(x, (0, m - k))


def _norm_scale(norm: str | None, n: int, forward: bool) -> float:
    """numpy norm conventions as a scalar factor on top of an
    UNNORMALIZED transform of length n (forward=True for the
    forward-like direction: fft/hfft; False for ifft/ihfft)."""
    if norm in (None, "backward"):
        return 1.0 if forward else 1.0 / n
    if norm == "ortho":
        return 1.0 / float(np.sqrt(n))
    if norm == "forward":
        return 1.0 / n if forward else 1.0
    raise ValueError(f"invalid norm value {norm!r}; expected None, "
                     f"'backward', 'ortho' or 'forward'")


def hfft(x: torch.Tensor, n: int | None = None, norm: str | None = None,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """FFT of a Hermitian-symmetric signal given by its half-spectrum
    (numpy ``hfft``): real (..., n) output from complex (..., n/2+1)
    input.  Rides the C2R kernel via hfft(x) = N * irfft(conj(x)) (the
    two are adjoint up to conjugation).  ``n`` pads/truncates the
    half-spectrum input to n/2+1 points; ``norm`` follows numpy
    ("backward"/"ortho"/"forward")."""
    if n is None:
        n = (x.shape[-1] - 1) * 2
    scale = _norm_scale(norm, n, forward=True)
    x = _fit_last(x, n // 2 + 1)
    out = api.irfft(x.conj(), n=n, backend=backend, precision=precision,
                    norm=None)
    return out * (2.0 * scale)   # the raw C2R output is (N/2)-scaled


def ihfft(x: torch.Tensor, n: int | None = None, norm: str | None = None,
          backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """Inverse of :func:`hfft` (numpy ``ihfft``): complex half-spectrum
    (..., n/2+1) from real (..., n) input = conj(rfft(x)) / n.  ``n``
    pads/truncates the real input (numpy semantics); ``norm`` follows
    numpy ("backward"/"ortho"/"forward")."""
    if n is None:
        n = x.shape[-1]
    scale = _norm_scale(norm, n, forward=False)
    x = _fit_last(x, n)
    return api.rfft(x, backend=backend, precision=precision).conj() * scale


def _irfftn(x, n, axes, backend, precision, norm):
    axes = _norm_axes(x.dim(), axes)
    if axes[-1] != x.dim() - 1:
        raise ValueError("irfft2 requires the last transform axis to be "
                         "the last array axis")
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.ifft(
            v, backend=backend, precision=precision, norm=norm))
    return api.irfft(x, n=n, backend=backend, precision=precision,
                     norm=norm)


@_call("irfft2", real_out=True)
def irfft2(x: torch.Tensor, n: int | None = None, axes=(-2, -1),
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> torch.Tensor:
    """2-D C2R inverse FFT (numpy ``irfft2``): inverse C2C over the
    leading transform axes, real inverse over the last."""
    return _irfftn(x, n, axes, backend, precision, norm)


# ---------------------------------------------------------------------------
# numpy-compatible spectral helpers
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, axes, sign: int) -> torch.Tensor:
    axes = _norm_axes(x.dim(), axes)
    return torch.roll(x, [sign * (x.shape[a] // 2) for a in axes], axes)


def fftshift(x: torch.Tensor, axes=None) -> torch.Tensor:
    """numpy ``fftshift``: move the zero-frequency bin to the center."""
    return _shift(x, axes, 1)


def ifftshift(x: torch.Tensor, axes=None) -> torch.Tensor:
    """numpy ``ifftshift``: undo :func:`fftshift`."""
    return _shift(x, axes, -1)


def fftfreq(n: int, d: float = 1.0) -> torch.Tensor:
    """numpy ``fftfreq`` as fp32 (bin center frequencies), a CPU
    tensor."""
    return torch.from_numpy(np.fft.fftfreq(n, d).astype(np.float32))


def rfftfreq(n: int, d: float = 1.0) -> torch.Tensor:
    """numpy ``rfftfreq`` as fp32 (one-sided bin frequencies), a CPU
    tensor."""
    return torch.from_numpy(np.fft.rfftfreq(n, d).astype(np.float32))
