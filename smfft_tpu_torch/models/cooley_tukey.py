"""Cooley–Tukey radix-2 DIT — the semantic spec, on torch tensors.

The executable contract of the reference's ``do_SMFFT_CT_DIT`` core
(SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:334-532): batched power-of-two
radix-2 decimation-in-time C2C transforms, forward and inverse, with
natural-order output (``fft_reorder=1``) or bit-reversed output
(``fft_reorder=0``).  Written so its correctness is obvious; the kernel
path in :mod:`smfft_tpu_torch.ops.c2c` is tested against it and numpy.

The reference's ``FFT_4096_inverse_noreorder`` plan silently runs forward
(SM_FFT_parameters.cuh:380-389); that bug is not replicated.
"""

from __future__ import annotations

import numpy as np
import torch


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reversal of i in log2(n) bits."""
    exp = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(exp):
        rev |= ((idx >> b) & 1) << (exp - 1 - b)
    return rev


def fft_dit(x: torch.Tensor, inverse: bool = False,
            ordered: bool = True) -> torch.Tensor:
    """Batched radix-2 DIT C2C FFT spec.

    Args:
      x: complex tensor (..., N), N a power of two.
      inverse: positive-exponent (unnormalized) transform if True — the
        reference never normalizes its inverse.
      ordered: natural-order output; if False, output is bit-reversed, i.e.
        ``out[i] == ordered_out[bit_reverse(i)]``.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("N must be a power of two")
    sign = +1.0 if inverse else -1.0

    def rec(v: torch.Tensor) -> torch.Tensor:
        m = v.shape[-1]
        if m == 1:
            return v
        even = rec(v[..., 0::2])
        odd = rec(v[..., 1::2])
        k = np.arange(m // 2)
        w = torch.from_numpy(np.exp(sign * 2j * np.pi * k / m)).to(
            device=v.device, dtype=v.dtype)
        t = w * odd
        return torch.cat([even + t, even - t], dim=-1)

    out = rec(x)
    if not ordered:
        out = out[..., torch.from_numpy(bit_reverse_indices(n)).to(x.device)]
    return out
