"""Stockham autosort family — the semantic spec, on torch tensors.

The executable contract of the reference's ``do_FFT_Stockham_mk6`` core
(SMFFT_Stockham_C2C/FFT-GPU-32bit-Stockham.cu:97-240) and the
direction-templated ``do_FFT_Stockham_C2C``
(SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:106-266): batched
power-of-two C2C transforms whose output is always in natural order — the
autosort dataflow folds the reordering into each stage's scatter, so no
bit-reversal pass exists (reference README.md:33-36).

The textbook iterative Stockham recurrence over A[l, m] = (DFT of length
L of the decimated subsequence x[m::M])[l], doubling L each stage: the
same dataflow as the reference's j*PoT+k scatter loops
(FFT-GPU-32bit-Stockham.cu:146-235), vectorized over the batch.
"""

from __future__ import annotations

import numpy as np
import torch


def fft_stockham(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Batched radix-2 Stockham autosort C2C FFT spec (always ordered).

    Args:
      x: complex tensor (..., N), N a power of two.
      inverse: positive-exponent unnormalized transform if True.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("N must be a power of two")
    sign = +1.0 if inverse else -1.0
    batch_shape = x.shape[:-1]
    a = x.reshape(batch_shape + (1, n))  # (..., L=1, M=N); A[l,m] = x[m]
    length, m = 1, n
    while m > 1:
        even = a[..., :, : m // 2]          # subsequences x[m::M] (even half)
        odd = a[..., :, m // 2:]            # subsequences x[m+M/2::M]
        k = np.arange(length)
        w = torch.from_numpy(np.exp(sign * 2j * np.pi * k / (2 * length))).to(
            device=x.device, dtype=x.dtype)
        t = w[:, None] * odd
        a = torch.cat([even + t, even - t], dim=-2)
        length, m = 2 * length, m // 2
    return a.reshape(batch_shape + (n,))
