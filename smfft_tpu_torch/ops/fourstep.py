"""Four-step (Bailey) decomposition: huge power-of-two C2C FFTs, and the
real transforms on top of them.

Counterpart of ``smfft_tpu/ops/fourstep.py``.  The row kernels stop at
N = 16384 (one transform in one thread block).  Beyond that N factors as
N1 * N2 (or more factors), and the length-N transform becomes batches of
short transforms glued by exact twiddle multiplies:

    A[n1, n2] = x[n1*N2 + n2]
    B[n2, k1] = FFT_N1(A[:, n2]) * W_N^(n2*k1)
    X[k2*N1 + k1] = FFT_N2(B[:, k1])[k2]

On the card every factor's transforms run in one launch of
``csrc/fourstep.cu`` (ops/fourstep_fused.py builds the launches); this
module keeps the size checks, the exact twiddle tables, and the four-step
written out over the row transforms (``backend="spec"``, the semantic
spec, as the JAX package's XLA path).

Twiddle exactness: the exponent is an exact integer and the root W_N^m is
split as W_N^(hi << LO) * W_N^lo, two tables of at most 2^14 (2^15 for
the real split at N = 2^29) entries, computed in float64 and rounded once
(:func:`_twiddle_tables`).  A naive fp32 angle 2 pi m / N would lose ~8
bits at N = 2^28.  The kernels read the same tables.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

#: low-table width: 2**14 entries.
_LO_BITS = 14

#: largest C2C four-step size: 16384 * 16384.
MAX_FOUR_STEP = 1 << 28


def split_factors(n: int, min_factor: int = 32) -> tuple[int, int]:
    """Balanced N = N1 * N2 split with both factors supported row sizes.

    Raises the reference-style size error when n is not a power of two,
    too small to split (< min_factor**2), or beyond 2**28."""
    if n <= 0 or (n & (n - 1)) != 0 or n > MAX_FOUR_STEP \
            or n < min_factor * min_factor:
        raise ValueError(
            f"Error wrong FFT length! N={n}; four-step supports powers of "
            f"two in [{min_factor * min_factor}, {MAX_FOUR_STEP}]")
    k = n.bit_length() - 1
    k1 = (k + 1) // 2
    return 1 << k1, 1 << (k - k1)


def _check_real_n(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0 or not 64 <= n <= 2 * MAX_FOUR_STEP:
        raise ValueError(
            f"Error wrong FFT length! N={n}; four-step real transforms "
            f"support powers of two in [64, {2 * MAX_FOUR_STEP}]")


def lo_bits(n: int) -> int:
    """Width of the low table for W_N (the high table holds N >> lo_bits
    entries: at most 2^14, 2^15 at N = 2^29)."""
    return min(_LO_BITS, n.bit_length() - 1)


@lru_cache(maxsize=None)
def _roots64(n: int, inverse: bool):
    """(lo, hi) complex128: W_N^j for j < 2**lo_bits and W_N^(i <<
    lo_bits) for i < N >> lo_bits (float64 host math)."""
    lb = lo_bits(n)
    sign = 2j * np.pi / n if inverse else -2j * np.pi / n
    lo = np.exp(sign * np.arange(1 << lb))
    hi = np.exp(sign * (np.arange(n >> lb, dtype=np.int64) << lb))
    lo.setflags(write=False)
    hi.setflags(write=False)
    return lo, hi


def _twiddle_tables(n: int, inverse: bool):
    """Planar (lo_r, lo_i, hi_r, hi_i) float32 tables, each entry rounded
    once from float64 (bit-identical to the JAX package's)."""
    lo, hi = _roots64(n, inverse)
    return (lo.real.astype(np.float32), lo.imag.astype(np.float32),
            hi.real.astype(np.float32), hi.imag.astype(np.float32))


@lru_cache(maxsize=None)
def device_roots(n: int, inverse: bool, exact: bool, device: torch.device):
    """The kernels' (lo, hi) tables on ``device`` as (k, 2) (re, im):
    float32, or float64 for the "exact" tier."""
    dt = np.float64 if exact else np.float32
    return tuple(torch.from_numpy(np.stack([t.real, t.imag], -1).astype(dt))
                 .to(device) for t in _roots64(n, inverse))


def roots(m: torch.Tensor, n: int, inverse: bool,
          dtype: torch.dtype) -> torch.Tensor:
    """W_N^m for an integer tensor m (0 <= m < N) as the kernels form it:
    hi[m >> lo_bits] * lo[m & mask], the two table entries rounded to
    ``dtype``'s precision (complex64 or complex128) and multiplied in it."""
    lb = lo_bits(n)
    lo, hi = (torch.from_numpy(t.copy()).to(device=m.device, dtype=dtype)
              for t in _roots64(n, inverse))
    return hi[m >> lb] * lo[m & ((1 << lb) - 1)]


def _half_root_planar(n: int, inverse: bool):
    """Planar (wr, wi) float32 tensors of W_N^k, k < N/2: the real split /
    merge twiddle at four-step scale, from the hi/lo tables."""
    w = roots(torch.arange(n // 2), n, inverse, torch.complex64)
    return w.real, w.imag


def twiddle_rows(b: torch.Tensor, n2: torch.Tensor, n: int,
                 inverse: bool) -> torch.Tensor:
    """B[..., r, k1] * W_N^(n2[r] * k1), the exponent reduced mod N in
    integers (n2 holds each row's global second index)."""
    k1 = torch.arange(b.shape[-1], device=b.device)
    m = (n2.to(torch.int64)[:, None] * k1[None, :]) % n
    return b * roots(m, n, inverse, b.dtype)


# ---------------------------------------------------------------------------
# The entry points under api.fft_large / ifft_large / rfft_large /
# irfft_large.
# ---------------------------------------------------------------------------


def _exact(precision: str | None) -> bool:
    from smfft_tpu_torch import api
    return api._exact(precision)


def _row_fft(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Ordered row transform of the spec, unnormalized both directions."""
    from smfft_tpu_torch import api
    if inverse:
        return api.ifft(x, backend="spec", norm=None)
    return api.fft(x, backend="spec")


def fft_four_step(x: torch.Tensor, *, inverse: bool = False,
                  backend: str = "auto", precision: str | None = None,
                  factors: tuple[int, int] | None = None,
                  scale: float = 1.0) -> torch.Tensor:
    """C2C FFT over the last axis for huge power-of-two N (2**15..2**28),
    batched over leading axes, unnormalized both directions unless
    ``scale`` (a power of two, e.g. 1/N) is given.

    ``backend="auto"``: the multi-pass kernel (ops/fourstep_fused.py) on a
    CUDA tensor, its plain version on a CPU tensor; ``factors`` selects the
    strided two-pass N1 x N2 plan.  ``backend="spec"``: the decomposition
    written out over the spec's row transforms."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    n = x.shape[-1]
    n1, n2 = factors if factors is not None else split_factors(n)
    if n1 * n2 != n:
        raise ValueError(f"factors {n1}*{n2} != N={n}")
    batch = x.shape[:-1]
    if backend == "spec":
        a = x.reshape(-1, n1, n2)
        b = _row_fft(a.transpose(-1, -2), inverse)
        b = twiddle_rows(b.reshape(-1, n1), torch.arange(n2).repeat(
            b.shape[0]), n, inverse).reshape(b.shape)
        c = _row_fft(b.transpose(-1, -2), inverse)
        out = c.transpose(-1, -2).reshape(batch + (n,))
        return out * scale if scale != 1.0 else out
    x2 = x.reshape(-1, n).resolve_conj().contiguous()
    passes = (FF.factors_plan(n1, n2) if factors is not None
              else FF.default_passes(n))
    y = FF.run_passes(x2, n, passes, inverse=inverse, scale=scale,
                      exact=_exact(precision))
    return y.reshape(batch + (n,))


def rfft_four_step(x: torch.Tensor, *, packed: bool = False,
                   backend: str = "auto",
                   precision: str | None = None) -> torch.Tensor:
    """Huge-N R2C: real (..., N) -> complex (..., N/2+1) numpy layout, or
    the reference's packed (..., N/2) layout with out[..., 0] = DC +
    1j*Nyquist.  N = 2**15..2**29.  ``backend="auto"`` runs
    ops/real_fused.py (C2C passes and the split kernel); ``"spec"`` the
    even/odd pack trick over :func:`fft_four_step`'s spec."""
    from smfft_tpu_torch.ops import real as R
    from smfft_tpu_torch.ops import real_fused as RF
    n = x.shape[-1]
    _check_real_n(n)
    batch, L = x.shape[:-1], n // 2
    rows = x.reshape(-1, n)
    layout = "packed" if packed else "numpy"
    if backend != "spec":
        y = RF.rfft_large_rows(rows, layout, exact=_exact(precision))
        return y.reshape(batch + (y.shape[-1],))
    zf = fft_four_step(torch.complex(rows[:, 0::2], rows[:, 1::2]),
                       backend="spec")
    zr, zi = zf.real, zf.imag
    mr, mi = R._mirror(zr), R._mirror(zi)
    er, ei = 0.5 * (zr + mr), 0.5 * (zi - mi)
    or_, oi = 0.5 * (zi + mi), 0.5 * (mr - zr)
    wr, wi = _half_root_planar(n, False)
    xr = er + wr * or_ - wi * oi
    xi = ei + wr * oi + wi * or_
    xr = torch.cat([zr[:, :1] + zi[:, :1], xr[:, 1:]], dim=1)
    xi = torch.cat([zr[:, :1] - zi[:, :1], xi[:, 1:]], dim=1)
    y = R.to_layout(xr, xi, layout)
    return y.reshape(batch + (y.shape[-1],))


def irfft_four_step(spec: torch.Tensor, n: int, *, packed: bool = False,
                    backend: str = "auto", precision: str | None = None,
                    normalize: bool = False) -> torch.Tensor:
    """Huge-N C2R inverse of :func:`rfft_four_step`: the reference's raw
    (N/2)-scaled signal (SMFFT_Stockham_R2C_C2R/FFT.c:170-171) unless
    ``normalize``."""
    _check_real_n(n)
    return irfft_scaled(spec, n, packed=packed, backend=backend,
                        exact=_exact(precision),
                        scale=1.0 / (n // 2) if normalize else None)


def irfft_scaled(spec: torch.Tensor, n: int, *, packed: bool,
                 backend: str, exact: bool,
                 scale: float | None) -> torch.Tensor:
    """scale * (the raw (N/2)-scaled C2R) of a numpy or packed spectrum."""
    from smfft_tpu_torch.ops import real as R
    from smfft_tpu_torch.ops import real_fused as RF
    L = n // 2
    layout = "packed" if packed else "numpy"
    bins = L if packed else L + 1
    if spec.shape[-1] != bins:
        raise ValueError(f"n={n} takes {bins} bins ({layout} layout), got "
                         f"{spec.shape[-1]}")
    batch = spec.shape[:-1]
    rows = spec.reshape(-1, bins).resolve_conj().contiguous()
    if backend != "spec":
        out = RF.irfft_large_rows(rows, None, n, layout, exact=exact,
                                  scale=scale)
        return out.reshape(batch + (n,))
    xr, xi = R.from_layout(rows, None, layout, L)
    zr, zi = R._merge(xr, xi, n, scale)
    z = fft_four_step(torch.complex(zr, zi), inverse=True, backend="spec")
    return torch.stack([z.real, z.imag], -1).reshape(batch + (n,))
