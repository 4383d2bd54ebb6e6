"""N-dimensional transforms and numpy-compatible spectral helpers.

The counterpart of ``smfft_tpu/ndim.py``, with the same names, signatures
and errors.  An N-D transform is a sequence of batched 1-D passes over the
last axis: each pass is one launch of a row kernel (``csrc/c2c.cu`` for
the C2C axes, ``csrc/real.cu`` / ``csrc/c2r.cu`` for the real axis), and a
pass over any other axis first moves that axis last with
``torch.transpose``.  The row kernels take contiguous rows, so the op
layer copies the transposed view once before the launch (``ops/c2c.py``
``fft_complex``, ``ops/real.py`` ``rows_of``): a 2-D FFT costs two kernel
passes plus one transposing copy.

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

import numpy as np
import torch
import torch.nn.functional as F

from smfft_tpu_torch import api


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


def fftn(x: torch.Tensor, axes=None, ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """N-D forward C2C FFT over ``axes`` (default: all axes), numpy
    ``fftn`` semantics.  Every transformed axis length must be a
    supported 1-D size.  ``ordered=False`` is only meaningful for a
    single transform axis (later passes need natural-order input)."""
    axes = _norm_axes(x.dim(), axes)
    if not ordered and len(axes) > 1:
        raise ValueError("ordered=False requires a single transform axis")
    for ax in axes:
        x = _apply_last(x, ax, lambda v: api.fft(
            v, ordered=ordered, backend=backend, precision=precision))
    return x


def ifftn(x: torch.Tensor, axes=None, backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> torch.Tensor:
    """N-D inverse C2C FFT over ``axes`` (numpy ``ifftn``: each axis
    divides by its length under ``norm="backward"``; ``norm=None`` is the
    raw inverse)."""
    axes = _norm_axes(x.dim(), axes)
    for ax in axes:
        x = _apply_last(x, ax, lambda v: api.ifft(
            v, backend=backend, precision=precision, norm=norm))
    return x


def fft2(x: torch.Tensor, axes=(-2, -1), ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """2-D forward C2C FFT (numpy ``fft2``)."""
    return fftn(x, axes=axes, ordered=ordered, backend=backend,
                precision=precision)


def ifft2(x: torch.Tensor, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> torch.Tensor:
    """2-D inverse C2C FFT (numpy ``ifft2``)."""
    return ifftn(x, axes=axes, backend=backend, precision=precision,
                 norm=norm)


def _check_real_last_axis(ndim: int, axes, fname: str):
    if axes[-1] != ndim - 1:
        raise ValueError(f"{fname} requires the last transform axis to "
                         f"be the last array axis (numpy applies the "
                         f"real transform there)")


def rfft2(x: torch.Tensor, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """2-D R2C FFT (numpy ``rfft2``): real kernel over ``axes[-1]``
    (half-spectrum output), C2C over the remaining axes."""
    axes = _norm_axes(x.dim(), axes)
    _check_real_last_axis(x.dim(), axes, "rfft2")
    x = api.rfft(x, backend=backend, precision=precision)
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.fft(
            v, backend=backend, precision=precision))
    return x


def rfftn(x: torch.Tensor, axes=None, backend: api.Backend = "auto",
          precision: str | None = None) -> torch.Tensor:
    """N-D R2C FFT (numpy ``rfftn``): real kernel over the last given
    axis (half-spectrum output), C2C over the rest.  Default: all axes.
    The last transform axis must be the last array axis (where numpy
    applies the real transform)."""
    axes = _norm_axes(x.dim(), axes)
    _check_real_last_axis(x.dim(), axes, "rfftn")
    return rfft2(x, axes=axes, backend=backend, precision=precision)


def irfftn(x: torch.Tensor, n: int | None = None, axes=None,
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> torch.Tensor:
    """N-D C2R inverse FFT (numpy ``irfftn``), inverse of
    :func:`rfftn`."""
    axes = _norm_axes(x.dim(), axes)
    _check_real_last_axis(x.dim(), axes, "irfftn")
    return irfft2(x, n=n, axes=axes, backend=backend,
                  precision=precision, norm=norm)


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


def irfft2(x: torch.Tensor, n: int | None = None, axes=(-2, -1),
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> torch.Tensor:
    """2-D C2R inverse FFT (numpy ``irfft2``): inverse C2C over the
    leading transform axes, real inverse over the last."""
    axes = _norm_axes(x.dim(), axes)
    if axes[-1] != x.dim() - 1:
        raise ValueError("irfft2 requires the last transform axis to be "
                         "the last array axis")
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.ifft(
            v, backend=backend, precision=precision, norm=norm))
    return api.irfft(x, n=n, backend=backend, precision=precision,
                     norm=norm)


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
