"""Public complex API — batched C2C FFTs over the last axis.

The L3 host interface of the reference (GPU_smFFT_4elements,
SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:827-908) behind its static size
switch (:599-659): unsupported sizes raise "Error wrong FFT length!".

Backends:
  * ``backend="auto"`` — dispatch on the tensor's device: a CUDA tensor
    runs the hand-written Hopper kernel (``csrc/c2c.cu``) or raises; a CPU
    tensor runs the kernel's plain PyTorch version.  Both give the same
    layouts, so CPU and GPU results agree.
  * ``backend="spec"`` — the radix-2 semantic spec (:mod:`models`), for
    debugging.  Its unordered output is bit-reversed, as the JAX spec's.

Unordered output (``ordered=False``) is revblock:
``out[..., k2*128 + k1] = X[k1*C + k2]`` with ``C = N/128``; natural
order for N <= 128.  :func:`ifft_unordered` consumes it directly.

Normalization follows numpy: ``ifft`` divides by N under
``norm="backward"``; ``norm=None`` gives the reference's raw inverse.  The
1/N is fused into the kernel's load.

Precision tiers ("highest", "exact", "high", "fast", "default") are
accepted for parity with the JAX package, whose tiers select bf16
matrix-unit pass schemes.  Those schemes exist only for the TPU's matrix
unit: here every tier runs the same fp32 kernel.  "default" still warns,
as it does there.

Ordered ``fft`` and ``ifft`` are differentiable through a
``torch.autograd.Function`` whose backward runs the same kernel.
"""

from __future__ import annotations

import warnings
from typing import Literal

import torch

from smfft_tpu_torch.models import cooley_tukey
from smfft_tpu_torch.ops import c2c as C

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
            "package runs every tier as the same fp32 kernel.",
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
    def forward(ctx, x, inverse: bool, scale):
        ctx.inverse, ctx.scale = inverse, scale
        return C.fft_complex(x, inverse=inverse, ordered=True, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (_OrderedC2C.apply(g, not ctx.inverse, ctx.scale), None,
                None)


def _c2c(x: torch.Tensor, inverse: bool, ordered: bool, backend: str,
         precision: str | None, scale: float | None) -> torch.Tensor:
    n = x.shape[-1]
    C.check_size(n)
    _resolve_precision(precision)
    _check_backend(backend)
    if backend == "spec":
        out = cooley_tukey.fft_dit(x, inverse=inverse, ordered=ordered)
        return out if scale is None else out * scale
    if ordered:
        return _OrderedC2C.apply(x, inverse, scale)
    return C.fft_complex(x, inverse=inverse, ordered=False, scale=scale)


def fft(x: torch.Tensor, ordered: bool = True, backend: Backend = "auto",
        precision: str | None = None) -> torch.Tensor:
    """Batched forward C2C FFT over the last axis.

    Args:
      x: complex64 (..., N), N in ``SUPPORTED_C2C_SIZES``.  For N < 128 the
        batch must be a multiple of 128/N (the reference's packing rule).
        CPU tensors may also be complex128 (the plain version is
        dtype-generic); the CUDA kernel takes complex64 only.
      ordered: natural-order output (reference ``fft_reorder=1``); False
        returns revblock (``fft_reorder=0``).  Only the ordered form is
        differentiable.
      backend: "auto" (by device) | "spec".
      precision: tier name, accepted for parity; see the module docstring.
    """
    return _c2c(x, False, ordered, backend, precision, None)


def ifft(x: torch.Tensor, ordered: bool = True, backend: Backend = "auto",
         precision: str | None = None,
         norm: str | None = "backward") -> torch.Tensor:
    """Batched inverse C2C FFT.  ``norm="backward"`` divides by N (numpy
    semantics); ``norm=None`` is the reference's unnormalized inverse.
    Differentiable when ``ordered=True``."""
    return _c2c(x, True, ordered, backend, precision,
                _norm_scale(norm, x.shape[-1]))


def ifft_unordered(x: torch.Tensor, backend: Backend = "auto",
                   precision: str | None = None,
                   norm: str | None = "backward") -> torch.Tensor:
    """Inverse C2C FFT consuming the layout ``fft(ordered=False)`` produces
    (revblock; bit-reversed for ``backend="spec"``) and returning natural
    order in one kernel pass: the relayout-free convolution round trip."""
    n = x.shape[-1]
    C.check_size(n)
    _resolve_precision(precision)
    _check_backend(backend)
    scale = _norm_scale(norm, n)
    if backend == "spec":
        perm = torch.from_numpy(cooley_tukey.bit_reverse_indices(n))
        out = cooley_tukey.fft_dit(x[..., perm.to(x.device)], inverse=True)
        return out if scale is None else out * scale
    return C.fft_complex(x, inverse=True, rev_in=True, scale=scale)
