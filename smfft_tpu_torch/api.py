"""Public API — batched C2C and real FFTs over the last axis.

The L3 host interface of the reference (GPU_smFFT_4elements,
SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:827-908; GPU_smFFT_R2C /
GPU_smFFT_C2R, SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:572-688)
behind its static size switch (:599-659): unsupported sizes raise "Error
wrong FFT length!".

Backends:
  * ``backend="auto"`` — dispatch on the tensor's device: a CUDA tensor
    runs the hand-written Hopper kernels (``csrc/c2c.cu``, ``csrc/real.cu``,
    ``csrc/c2r.cu``) or raises; a CPU tensor runs the kernels' plain
    PyTorch versions.  Both give the same layouts, so CPU and GPU results
    agree.
  * ``backend="spec"`` — the semantic specs (:mod:`models`), for
    debugging.  Its unordered C2C output is bit-reversed, as the JAX
    spec's.

Unordered output (``ordered=False``) is revblock:
``out[..., k2*128 + k1] = X[k1*C + k2]`` with ``C = N/128``; natural
order for N <= 128.  :func:`ifft_unordered` consumes it directly.

Normalization follows numpy: ``ifft`` divides by N and ``irfft`` by N
(the raw C2R output is (N/2)-scaled, so by N/2 there) under
``norm="backward"``; ``norm=None`` gives the reference's raw inverses.  The
scale is fused into the kernels.

Precision tiers ("highest", "exact", "high", "fast", "default") are
accepted for parity with the JAX package, whose tiers select bf16
matrix-unit pass schemes.  Those schemes exist only for the TPU's matrix
unit.  Here "exact" keeps its contract, <= 2 ulp of max|X|, with the
kernels' fp64-arithmetic instantiation (the plain version computes in
float64 and rounds once); every other tier runs the fp32 kernels.
"default" still warns, as it does there.

Ordered ``fft`` and ``ifft``, ``rfft`` and numpy-layout ``irfft`` are
differentiable through ``torch.autograd.Function``s whose backward runs a
kernel.  The packed real layout (slot 0 = DC + i*Nyquist) has no gradient,
as in the JAX package.

``convolve`` / ``convolve_real`` run the fused convolution kernels
(``csrc/conv.cu``: forward transform, filter product, inverse transform in
one pass), for one filter or a bank, and are differentiable in both the
signal and the filter.

``fft_large`` / ``ifft_large`` (N to 2^28) and ``rfft_large`` /
``irfft_large`` (n to 2^29) run the huge-N passes (``csrc/fourstep.cu``,
whose last pass does the pair mode's split to radix 256, and
``csrc/real_huge.cu``'s other splits and the merges); sizes the row
kernels take route to ``fft`` / ``rfft`` / ``irfft``.  They are
differentiable, the packed real layout excepted.
"""

from __future__ import annotations

import warnings
from typing import Literal

import torch

from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.models import cooley_tukey
from smfft_tpu_torch.models import real as real_model
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.ops import fourstep as FS
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES

Backend = Literal["auto", "spec"]

PRECISIONS = ("highest", "exact", "high", "fast", "default")
_warned_precisions: set[str] = set()


def _resolve_precision(precision: str | None) -> str:
    """None -> the process default (``config.flags.precision``)."""
    if precision is None:
        from smfft_tpu_torch.config import flags
        precision = flags.precision
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    if precision == "default" and precision not in _warned_precisions:
        _warned_precisions.add(precision)
        warnings.warn(
            "precision='default' names the JAX package's single-bf16-pass "
            "hardware-parity tier, whose accuracy is unusable there; this "
            "package runs it as the fp32 kernels ('highest').",
            UserWarning, stacklevel=3)
    return precision


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "spec"):
        raise ValueError(f"unknown backend {backend!r}; one of 'auto', "
                         "'spec'")


def _norm_scale(norm: str | None, n: int) -> float | None:
    if norm == "backward":
        return 1.0 / n
    if norm is None:
        return None
    raise ValueError(f"norm must be 'backward' or None, got {norm!r}")


class _OrderedC2C(torch.autograd.Function):
    """Ordered C2C with the kernel in both passes.

    PyTorch's gradient of a complex function is the conjugate (Wirtinger)
    one: for y = s * F x the input gradient is s * F^H g.  The DFT matrix
    is symmetric, so F^H = conj(F): the backward of a forward transform is
    the raw inverse transform of g, and vice versa, with the same real
    scale.  (JAX's VJP is the transpose F^T = F, which is why the JAX
    package applies the same transform.)
    """

    @staticmethod
    def forward(ctx, x, inverse: bool, scale, exact: bool):
        ctx.inverse, ctx.scale, ctx.exact = inverse, scale, exact
        t = _T.on and _T.now()
        try:
            return C.fft_complex(x, inverse=inverse, ordered=True, scale=scale,
                                 exact=exact)
        finally:
            if t:
                _T.record(t, "op:ordered_c2c")

    @staticmethod
    def backward(ctx, g):
        return (_OrderedC2C.apply(g, not ctx.inverse, ctx.scale, ctx.exact),
                None, None, None)


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    """A real input as complex64, as the JAX package promotes it; complex
    tensors (complex128 included) pass unchanged."""
    return x if x.is_complex() else x.to(torch.complex64)


def _as_real(x: torch.Tensor) -> torch.Tensor:
    """A real input to a real transform as float32, as the JAX package
    promotes it: integer, bool, float16 and bfloat16 tensors.  float32 and
    (on the CPU) float64 pass unchanged, and so does a complex tensor,
    which the transform rejects itself."""
    if x.is_complex() or x.dtype in (torch.float32, torch.float64):
        return x
    return x.to(torch.float32)


def _exact(precision: str | None) -> bool:
    """Resolve the tier; True when it runs the "exact" instantiation."""
    return _resolve_precision(precision) == "exact"


def _c2c(x: torch.Tensor, inverse: bool, ordered: bool, backend: str,
         precision: str | None, scale: float | None) -> torch.Tensor:
    x = _as_complex(x)
    n = x.shape[-1]
    C.check_size(n)
    exact = _exact(precision)
    _check_backend(backend)
    if backend == "spec":
        out = cooley_tukey.fft_dit(x, inverse=inverse, ordered=ordered)
        return out if scale is None else out * scale
    if ordered:
        return _OrderedC2C.apply(x, inverse, scale, exact)
    t = _T.on and _T.now()
    try:
        return C.fft_complex(x, inverse=inverse, ordered=False, scale=scale,
                             exact=exact)
    finally:
        if t:
            _T.record(t, "op:fft_complex")


def fft(x: torch.Tensor, ordered: bool = True, backend: Backend = "auto",
        precision: str | None = None) -> torch.Tensor:
    """Batched forward C2C FFT over the last axis.

    Args:
      x: complex64 (..., N), N in ``SUPPORTED_C2C_SIZES``.  For N < 128 the
        batch must be a multiple of 128/N (the reference's packing rule).
        A real tensor is promoted to complex64.  CPU tensors may also be
        complex128 (the plain version is dtype-generic); the CUDA kernel
        takes complex64 only.
      ordered: natural-order output (reference ``fft_reorder=1``); False
        returns revblock (``fft_reorder=0``).  Only the ordered form is
        differentiable.
      backend: "auto" (by device) | "spec".
      precision: tier name, accepted for parity; see the module docstring.
    """
    t = _T.on and _T.now()
    try:
        return _c2c(x, False, ordered, backend, precision, None)
    finally:
        if t:
            _T.record(t, "call:fft", x)


def ifft(x: torch.Tensor, ordered: bool = True, backend: Backend = "auto",
         precision: str | None = None,
         norm: str | None = "backward") -> torch.Tensor:
    """Batched inverse C2C FFT.  ``norm="backward"`` divides by N (numpy
    semantics); ``norm=None`` is the reference's unnormalized inverse.
    Differentiable when ``ordered=True``."""
    t = _T.on and _T.now()
    try:
        return _c2c(x, True, ordered, backend, precision,
                    _norm_scale(norm, x.shape[-1]))
    finally:
        if t:
            _T.record(t, "call:ifft", x)


def ifft_unordered(x: torch.Tensor, backend: Backend = "auto",
                   precision: str | None = None,
                   norm: str | None = "backward") -> torch.Tensor:
    """Inverse C2C FFT consuming the layout ``fft(ordered=False)`` produces
    (revblock; bit-reversed for ``backend="spec"``) and returning natural
    order in one kernel pass: the relayout-free convolution round trip."""
    t = _T.on and _T.now()
    try:
        x = _as_complex(x)
        n = x.shape[-1]
        C.check_size(n)
        exact = _exact(precision)
        _check_backend(backend)
        scale = _norm_scale(norm, n)
        if backend == "spec":
            perm = torch.from_numpy(cooley_tukey.bit_reverse_indices(n))
            out = cooley_tukey.fft_dit(x[..., perm.to(x.device)], inverse=True)
            return out if scale is None else out * scale
        t_op = _T.on and _T.now()
        try:
            return C.fft_complex(x, inverse=True, rev_in=True, scale=scale,
                                 exact=exact)
        finally:
            if t_op:
                _T.record(t_op, "op:fft_complex")
    finally:
        if t:
            _T.record(t, "call:ifft_unordered", x)


# ---------------------------------------------------------------------------
# Real transforms.
# ---------------------------------------------------------------------------


def _rfft_op(x: torch.Tensor, backend: str, exact: bool,
             packed: bool) -> torch.Tensor:
    """real (..., n) -> numpy (..., n/2+1) or packed (..., n/2)."""
    n = x.shape[-1]
    if backend == "spec":
        return real_model.rfft_spec(x, packed=packed)
    rows, batch_shape, b = R.rows_of(x, n)
    R.check_pack(b, n)
    y = R.rfft_rows(rows, "packed" if packed else "numpy", exact)
    return y.reshape(batch_shape + (y.shape[-1],))


def _irfft_op(x: torch.Tensor, n: int, backend: str, exact: bool,
              scale: float | None, packed: bool) -> torch.Tensor:
    """numpy (..., n/2+1) or packed (..., n/2) -> scale * (n/2) * irfft,
    real (..., n)."""
    if backend == "spec":
        out = real_model.irfft_spec(x, n, packed=packed)
        return out if scale is None else out * scale
    rows, batch_shape, b = R.rows_of(x, x.shape[-1])
    R.check_pack(b, n)
    out = R.irfft_rows(rows.resolve_conj(), n=n,
                       layout="packed" if packed else "numpy", scale=scale,
                       exact=exact)
    return out.reshape(batch_shape + (n,))


def _half_weights(n: int, interior: float, like: torch.Tensor):
    """[1, interior, ..., interior, 1] over the n/2 + 1 bins."""
    w = torch.full((n // 2 + 1,), interior, device=like.device,
                   dtype=like.real.dtype if like.is_complex() else like.dtype)
    w[0] = w[-1] = 1.0
    return w


class _RFFT(torch.autograd.Function):
    """R2C (numpy layout) with a C2R kernel in the backward.

    For real x and y = rfft(x), PyTorch's gradient (the conjugate
    convention, as in :class:`_OrderedC2C`) is gx[m] = Re sum_k g[k]
    W_n^{-km} over the n/2 + 1 bins, which is n * irfft(g * s), s = [1,
    1/2, ..., 1/2, 1]: the raw C2R ((n/2) * irfft) at scale 2.  irfft
    ignores the imaginary parts of DC and Nyquist, as the sum's real part
    does.  (JAX's VJP conjugates g instead: its transpose convention.)
    """

    @staticmethod
    def forward(ctx, x, backend: str, exact: bool):
        ctx.backend, ctx.exact = backend, exact
        t = _T.on and _T.now()
        try:
            return _rfft_op(x, backend, exact, packed=False)
        finally:
            if t:
                _T.record(t, "op:rfft")

    @staticmethod
    def backward(ctx, g):
        n = (g.shape[-1] - 1) * 2
        gs = g * _half_weights(n, 0.5, g)
        return (_irfft_op(gs, n, ctx.backend, ctx.exact, 2.0, packed=False),
                None, None)


class _IRFFT(torch.autograd.Function):
    """C2R (numpy layout) with an R2C kernel in the backward.

    y = scale * (n/2) * irfft(h); for each bin PyTorch's gradient is
    dL/dRe h + i dL/dIm h = scale * rfft(g) * d / 2, d = [1, 2, ..., 2,
    1]: the interior bins appear twice in irfft (as h and conj h), and DC
    and Nyquist get no imaginary gradient (rfft(g) is real there, g being
    real).
    """

    @staticmethod
    def forward(ctx, h, n: int, backend: str, exact: bool, scale):
        ctx.n, ctx.backend, ctx.exact, ctx.scale = n, backend, exact, scale
        t = _T.on and _T.now()
        try:
            return _irfft_op(h, n, backend, exact, scale, packed=False)
        finally:
            if t:
                _T.record(t, "op:irfft")

    @staticmethod
    def backward(ctx, g):
        s = 1.0 if ctx.scale is None else ctx.scale
        gh = _rfft_op(g.contiguous(), ctx.backend, ctx.exact, packed=False)
        return (gh * (_half_weights(ctx.n, 2.0, gh) * (0.5 * s)), None,
                None, None, None)


class _Packed(torch.autograd.Function):
    """A packed-layout real transform, which has no gradient: slot 0 packs
    DC and Nyquist into one complex number (as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, run):
        t = _T.on and _T.now()
        try:
            return run(x)
        finally:
            if t:
                _T.record(t, "op:packed")

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the packed real layout (slot 0 = DC + 1j*Nyquist) has no "
            "gradient; differentiate rfft / irfft(packed=False) instead")


def real_norm_scale(norm: str | None, n: int) -> float | None:
    """The C2R scale: numpy ``"backward"`` divides the raw (n/2)-scaled
    output by n/2; None keeps the raw contract."""
    if norm == "backward":
        return 1.0 / (n // 2)
    if norm is None:
        return None
    raise ValueError(f"norm must be 'backward' or None, got {norm!r}")


def rfft(x: torch.Tensor, backend: Backend = "auto",
         precision: str | None = None) -> torch.Tensor:
    """Batched R2C FFT: real (..., N) -> complex (..., N/2+1), numpy
    layout.  N in ``SUPPORTED_REAL_SIZES``; at N = 64 / 128 the batch must
    be a multiple of 4 / 2 (the JAX package's rule).  The CUDA kernel
    takes float32; CPU tensors may also be float64; integer, bool and
    half-precision tensors are promoted to float32.  Differentiable."""
    t = _T.on and _T.now()
    try:
        x = _as_real(x)
        R.check_size(x.shape[-1])
        exact = _exact(precision)
        _check_backend(backend)
        return _RFFT.apply(x, backend, exact)
    finally:
        if t:
            _T.record(t, "call:rfft", x)


def fft_packed_real(x: torch.Tensor, backend: Backend = "auto",
                    precision: str | None = None) -> torch.Tensor:
    """R2C in the reference's packed layout: (..., N/2) complex with
    out[..., 0] = DC + 1j*Nyquist (FFT-GPU-32bit-Stockham.cu:332-340).
    Not differentiable."""
    t = _T.on and _T.now()
    try:
        x = _as_real(x)
        R.check_size(x.shape[-1])
        exact = _exact(precision)
        _check_backend(backend)
        return _Packed.apply(x, lambda a: _rfft_op(a, backend, exact, True))
    finally:
        if t:
            _T.record(t, "call:fft_packed_real", x)


def irfft(x: torch.Tensor, n: int | None = None, backend: Backend = "auto",
          precision: str | None = None, norm: str | None = "backward",
          packed: bool = False) -> torch.Tensor:
    """Batched C2R inverse FFT: complex spectrum -> real (..., N).

    ``x`` is (..., N/2+1) in numpy layout (the imaginary parts of DC and
    Nyquist are ignored) or, with ``packed``, (..., N/2) with slot 0 =
    DC + 1j*Nyquist.  ``norm="backward"`` divides by N (numpy);
    ``norm=None`` returns the reference's raw (N/2)-scaled output
    (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  The numpy-layout form is
    differentiable."""
    if n is None:
        n = (x.shape[-1] - 1) * 2 if not packed else x.shape[-1] * 2
    t = _T.on and _T.now()
    try:
        x = _as_complex(x)
        R.check_size(n)
        bins = n // 2 if packed else n // 2 + 1
        if x.shape[-1] != bins:
            layout = "packed" if packed else "numpy"
            raise ValueError(f"n={n} takes {bins} bins ({layout} layout), "
                             f"got {x.shape[-1]}")
        exact = _exact(precision)
        _check_backend(backend)
        scale = real_norm_scale(norm, n)
        if packed:
            return _Packed.apply(
                x, lambda h: _irfft_op(h, n, backend, exact, scale, True))
        return _IRFFT.apply(x, n, backend, exact, scale)
    finally:
        if t:
            _T.record(t, "call:irfft", x, n)


# ---------------------------------------------------------------------------
# Fused convolution.
# ---------------------------------------------------------------------------


def _conv_op(x: torch.Tensor, h: torch.Tensor, exact: bool,
             real: bool) -> torch.Tensor:
    """x (..., n) against h (bins,) or a bank (m, bins) -> (..., n) or
    (m, ..., n), through the fused kernels (CV.conv_rows,
    CV.conv_real_rows) or their plain versions."""
    n = x.shape[-1]
    rows, batch_shape, b = R.rows_of(x.resolve_conj(), n)
    h2 = h.resolve_conj().reshape(-1, h.shape[-1])
    if real:
        y = CV.conv_real_rows(rows, h2, exact)
    else:
        C.check_pack(b, n)
        y = CV.conv_rows(rows, None, h2, exact)
    lead = (h2.shape[0],) if h.dim() == 2 else ()
    return y.reshape(lead + batch_shape + (n,))


def _bank_sum(fn, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """fn(g, h) for one filter; sum_j fn(g[j], h[j]) for a bank."""
    if h.dim() == 1:
        return fn(g, h)
    return sum(fn(g[j], h[j]) for j in range(h.shape[0]))


class _Convolve(torch.autograd.Function):
    """The fused convolutions with gradients for the signal and the
    filter (the JAX package's ``_diff_convolve``, which differentiates the
    unfused composition).

    Complex: y = ifft(X * H), X = fft(x).  y is linear in x with operator
    A = F^H diag(H) F / N, and PyTorch's conjugate convention gives gx =
    A^H g = ifft(fft(g) * conj H): the same fused kernel with conj(H) (for
    a bank, the sum of that over the filters).  In H, y = F^H diag(X) H /
    N, so gH = conj(X) * fft(g) / N, summed over the batch.

    Real: y = irfft(X * H), X = rfft(x), which ignores Im H[0] and Im H[L]
    (L = n/2).  The operator is real, so gx = A^T g = irfft(rfft(g) *
    conj H): the fused kernel again.  The gradient of irfft's input is
    rfft(g) * w / n with w = [1, 2, ..., 2, 1] (the interior bins appear
    twice, as H and conj H; see :class:`_IRFFT`), so gH = conj(X) *
    rfft(g) * w / n, real at DC and Nyquist.

    The transforms in the filter gradient are the package's own ``fft`` /
    ``rfft`` (the C2C or R2C kernel on the card).
    """

    @staticmethod
    def forward(ctx, x, h, exact: bool, real: bool):
        ctx.exact, ctx.real = exact, real
        ctx.save_for_backward(x, h)
        t = _T.on and _T.now()
        try:
            return _conv_op(x, h, exact, real)
        finally:
            if t:
                _T.record(t, "op:convolve")

    @staticmethod
    def backward(ctx, g):
        x, h = ctx.saved_tensors
        exact, real = ctx.exact, ctx.real
        n = x.shape[-1]
        gx = gh = None
        if ctx.needs_input_grad[0]:
            gx = _bank_sum(lambda gj, hj: _conv_op(gj, hj.conj(), exact,
                                                   real), g, h)
        if ctx.needs_input_grad[1]:
            prec = "exact" if exact else "highest"
            tr = rfft if real else fft
            xs = tr(x.detach(), precision=prec).reshape(-1, h.shape[-1])
            gs = tr(g.contiguous(), precision=prec)
            gs = gs.reshape(h.shape[:-1] + (-1, h.shape[-1]))
            gh = (xs.conj() * gs).sum(dim=-2) / n
            if real:
                gh = gh * _half_weights(n, 2.0, gh)
        return gx, gh, None, None


def convolve(x: torch.Tensor, h: torch.Tensor, backend: Backend = "auto",
             precision: str | None = None) -> torch.Tensor:
    """Batched circular convolution ``ifft(fft(x) * h)`` (numpy
    normalization) in one fused kernel pass.

    Args:
      x: complex (..., N) signal batch, N a supported C2C size; for N < 128
        the batch must be a multiple of 128/N (the reference's rule).
      h: complex (N,) frequency response in natural order (compute it once
        with ``fft(h_time)``), or an (M, N) bank, giving (M, ..., N): each
        signal's forward transform is computed once for the whole bank,
        in the kernel.
      backend / precision: as :func:`fft`.

    Differentiable in both ``x`` and ``h``.
    """
    t = _T.on and _T.now()
    try:
        n = x.shape[-1]
        C.check_size(n)
        bank = h.dim() == 2
        if tuple(h.shape) != (n,) and not (bank and h.shape[-1] == n):
            raise ValueError(f"filter must be natural-order frequency "
                             f"response of shape ({n},) or (M, {n}), got "
                             f"{tuple(h.shape)}")
        exact = _exact(precision)
        _check_backend(backend)
        x = _as_complex(x)
        if backend == "spec":
            spec = fft(x, backend="spec")
            spec = spec[None] * h.reshape((h.shape[0],) + (1,) * (x.dim() - 1)
                                          + (n,)) if bank else spec * h
            return ifft(spec, backend="spec")
        return _Convolve.apply(x, h, exact, False)
    finally:
        if t:
            _T.record(t, "call:convolve", x)


def convolve_real(x: torch.Tensor, h: torch.Tensor,
                  backend: Backend = "auto",
                  precision: str | None = None) -> torch.Tensor:
    """Batched real circular convolution ``irfft(rfft(x) * h)`` in one
    fused kernel pass, at half the traffic of :func:`convolve`.

    Args:
      x: real (..., N) signal batch, N >= 256 a supported real size.
      h: complex (N/2+1,) rfft-style response in natural order (compute it
        once with ``rfft(h_time)``; the imaginary parts of DC and Nyquist
        are ignored, zero for any real filter), or an (M, N/2+1) bank,
        giving (M, ..., N).

    Differentiable in both ``x`` and ``h``.
    """
    t = _T.on and _T.now()
    try:
        x = _as_real(x)
        n = x.shape[-1]
        if n not in SUPPORTED_REAL_SIZES or n < 256:
            raise ValueError(
                f"Error wrong FFT length! N={n}; real convolve supports "
                f"{[s for s in SUPPORTED_REAL_SIZES if s >= 256]}")
        bank = h.dim() == 2
        if tuple(h.shape) != (n // 2 + 1,) and not (bank and h.shape[-1]
                                                     == n // 2 + 1):
            raise ValueError(f"filter must be an rfft-style frequency "
                             f"response of shape ({n // 2 + 1},) or (M, "
                             f"{n // 2 + 1}), got {tuple(h.shape)}")
        exact = _exact(precision)
        _check_backend(backend)
        if backend == "spec":
            spec = rfft(x, backend="spec")
            spec = spec[None] * h.reshape(
                (h.shape[0],) + (1,) * (x.dim() - 1)
                + (n // 2 + 1,)) if bank else spec * h
            return irfft(spec, n=n, backend="spec")
        return _Convolve.apply(x, h, exact, True)
    finally:
        if t:
            _T.record(t, "call:convolve_real", x)


# ---------------------------------------------------------------------------
# Huge N.
# ---------------------------------------------------------------------------


class _LargeC2C(torch.autograd.Function):
    """Huge-N C2C with the kernels in both passes: as for
    :class:`_OrderedC2C`, the backward of a transform of scale s is the
    raw transform of the opposite direction at the same scale."""

    @staticmethod
    def forward(ctx, x, inverse: bool, scale, exact: bool, backend: str):
        ctx.args = (inverse, scale, exact, backend)
        t = _T.on and _T.now()
        try:
            return FS.fft_four_step(
                x, inverse=inverse, backend=backend,
                precision="exact" if exact else "highest",
                scale=1.0 if scale is None else scale)
        finally:
            if t:
                _T.record(t, "op:large_c2c")

    @staticmethod
    def backward(ctx, g):
        inverse, scale, exact, backend = ctx.args
        return (_LargeC2C.apply(g.contiguous(), not inverse, scale, exact,
                                backend), None, None, None, None)


def fft_large(x: torch.Tensor, backend: Backend = "auto",
              precision: str | None = None) -> torch.Tensor:
    """Forward C2C FFT for huge power-of-two N (2**15..2**28), batched over
    leading axes: the multi-pass four-step (ops/fourstep_fused.py, one
    launch of ``csrc/fourstep.cu`` per pass).  Sizes <= 16384 route to
    :func:`fft`.  A real input is promoted to complex64.  Differentiable."""
    t = _T.on and _T.now()
    try:
        x = _as_complex(x)
        n = x.shape[-1]
        if n in SUPPORTED_C2C_SIZES:
            return fft(x, backend=backend, precision=precision)
        FS.split_factors(n)
        exact = _exact(precision)
        _check_backend(backend)
        return _LargeC2C.apply(x, False, None, exact, backend)
    finally:
        if t:
            _T.record(t, "call:fft_large", x)


def ifft_large(x: torch.Tensor, backend: Backend = "auto",
               precision: str | None = None,
               norm: str | None = "backward") -> torch.Tensor:
    """Inverse of :func:`fft_large`.  ``norm="backward"`` divides by N
    (numpy, folded into the first pass); ``norm=None`` is the reference's
    raw unnormalized inverse."""
    t = _T.on and _T.now()
    try:
        x = _as_complex(x)
        if norm not in ("backward", None):
            raise ValueError(
                f"ifft_large supports norm='backward' (numpy) or norm=None "
                f"(raw reference scale); got {norm!r}")
        n = x.shape[-1]
        if n in SUPPORTED_C2C_SIZES:
            return ifft(x, backend=backend, precision=precision, norm=norm)
        FS.split_factors(n)
        exact = _exact(precision)
        _check_backend(backend)
        return _LargeC2C.apply(x, True, _norm_scale(norm, n), exact, backend)
    finally:
        if t:
            _T.record(t, "call:ifft_large", x)


class _RFFTLarge(torch.autograd.Function):
    """Huge-N R2C (numpy layout); the backward is :class:`_RFFT`'s rule
    with the huge-N C2R: n * irfft(g * s)."""

    @staticmethod
    def forward(ctx, x, exact: bool, backend: str):
        ctx.exact, ctx.backend = exact, backend
        t = _T.on and _T.now()
        try:
            return FS.rfft_four_step(x, backend=backend,
                                     precision="exact" if exact else "highest")
        finally:
            if t:
                _T.record(t, "op:rfft_large")

    @staticmethod
    def backward(ctx, g):
        n = (g.shape[-1] - 1) * 2
        gs = g * _half_weights(n, 0.5, g)
        return (FS.irfft_scaled(gs, n, packed=False, backend=ctx.backend,
                                exact=ctx.exact, scale=2.0), None, None)


class _IRFFTLarge(torch.autograd.Function):
    """Huge-N C2R (numpy layout); the backward is :class:`_IRFFT`'s rule
    with the huge-N R2C."""

    @staticmethod
    def forward(ctx, h, n: int, exact: bool, backend: str, scale):
        ctx.n, ctx.exact, ctx.backend, ctx.scale = n, exact, backend, scale
        t = _T.on and _T.now()
        try:
            return FS.irfft_scaled(h, n, packed=False, backend=backend,
                                   exact=exact, scale=scale)
        finally:
            if t:
                _T.record(t, "op:irfft_large")

    @staticmethod
    def backward(ctx, g):
        s = 1.0 if ctx.scale is None else ctx.scale
        gh = FS.rfft_four_step(g.contiguous(), backend=ctx.backend,
                               precision="exact" if ctx.exact else "highest")
        return (gh * (_half_weights(ctx.n, 2.0, gh) * (0.5 * s)), None,
                None, None, None)


def rfft_large(x: torch.Tensor, backend: Backend = "auto",
               precision: str | None = None,
               packed: bool = False) -> torch.Tensor:
    """R2C FFT for huge power-of-two N (2**15..2**29): the huge-N C2C
    passes and the split, in the last pass (pair mode, its radix at most
    256) or a pass of its own (ops/real_fused.py; the mode by batch,
    :func:`~smfft_tpu_torch.ops.real_fused.choose_mode`).  Numpy layout
    (..., N/2+1), or with ``packed`` the reference's (..., N/2) with
    out[..., 0] = DC + 1j*Nyquist.  Sizes <= 16384 route to :func:`rfft` /
    :func:`fft_packed_real`.  The numpy layout is differentiable."""
    t = _T.on and _T.now()
    try:
        x = _as_real(x)
        n = x.shape[-1]
        if n in SUPPORTED_REAL_SIZES:
            if packed:
                return fft_packed_real(x, backend=backend, precision=precision)
            return rfft(x, backend=backend, precision=precision)
        FS._check_real_n(n)
        exact = _exact(precision)
        _check_backend(backend)
        if packed:
            return _Packed.apply(x, lambda a: FS.rfft_four_step(
                a, packed=True, backend=backend,
                precision="exact" if exact else "highest"))
        return _RFFTLarge.apply(x, exact, backend)
    finally:
        if t:
            _T.record(t, "call:rfft_large", x)


def irfft_large(x: torch.Tensor, n: int | None = None,
                backend: Backend = "auto", precision: str | None = None,
                norm: str | None = "backward",
                packed: bool = False) -> torch.Tensor:
    """Inverse of :func:`rfft_large`.  ``norm="backward"`` returns the
    signal (numpy); ``norm=None`` keeps the reference's raw (N/2)-scaled
    output (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  The numpy layout is
    differentiable."""
    if n is None:
        n = (x.shape[-1] - 1) * 2 if not packed else x.shape[-1] * 2
    t = _T.on and _T.now()
    try:
        if norm not in ("backward", None):
            raise ValueError(
                f"irfft_large supports norm='backward' (numpy) or norm=None "
                f"(raw reference scale); got {norm!r}")
        if n in SUPPORTED_REAL_SIZES:
            return irfft(x, n=n, backend=backend, precision=precision,
                         norm=norm, packed=packed)
        FS._check_real_n(n)
        exact = _exact(precision)
        _check_backend(backend)
        scale = real_norm_scale(norm, n)
        if packed:
            return _Packed.apply(x, lambda h: FS.irfft_scaled(
                h, n, packed=True, backend=backend, exact=exact, scale=scale))
        return _IRFFTLarge.apply(x, n, exact, backend, scale)
    finally:
        if t:
            _T.record(t, "call:irfft_large", x, n)
