"""Real-transform family (R2C / C2R) via the half-size packing trick — the
semantic spec, on torch tensors.

Mirrors the reference's ``do_FFT_Stockham_R2C_C2R``
(SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344): a real
transform of length N is a complex transform of length L = N/2 on packed
(even, odd) samples, followed by a split/merge post-process with W(N, k)
twiddles (:289-328), with element 0 packing the two purely real spectrum
values DC and Nyquist as (re, im) of one complex slot (:332-340).

Math:
  E[m] = x[2m], O[m] = x[2m+1], Z = DFT_L(E + iO)
  Ê[k] = (Z[k] + conj(Z[-k]))/2,  Ô[k] = (Z[k] - conj(Z[-k]))/(2i)
  X[k] = Ê[k] + W_N^k Ô[k]  for k = 0..L,   X[L] = Ê[0] - Ô[0]

Two output layouts:
  * ``packed=False`` (default): numpy-compatible ``(..., L+1)`` rfft layout.
  * ``packed=True``: the reference's L-slot layout with
    ``out[..., 0] = DC + 1j*Nyquist`` (FFT-GPU-32bit-Stockham.cu:332-340).

Normalization: like the reference, the C2R inverse is unnormalized — it
returns ``(N/2) * x`` (the harness divides by N/2 when comparing,
SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  Pass ``normalize=True`` for the
convenience scaling.
"""

from __future__ import annotations

import numpy as np
import torch

from smfft_tpu_torch.models.stockham import fft_stockham


def _complex_dtype(t: torch.Tensor) -> torch.dtype:
    return (torch.complex128 if t.dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device,
                                  dtype=_complex_dtype(like))


def pack_real(x: torch.Tensor) -> torch.Tensor:
    """Interleave a real signal (..., N) into complex (..., N/2):
    even + i*odd."""
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    return torch.complex(x[..., 0::2], x[..., 1::2])


def _split_forward(z: torch.Tensor, n: int, packed: bool) -> torch.Tensor:
    """Post-process the half-size spectrum Z (..., L) into the real
    spectrum."""
    L = n // 2
    zrev = torch.roll(torch.flip(z, [-1]), 1, -1)  # Z[(L-k) mod L]
    e = 0.5 * (z + torch.conj(zrev))
    o = -0.5j * (z - torch.conj(zrev))
    w = _const(np.exp(-2j * np.pi * np.arange(L) / n), z)
    full = e + w * o                                  # X[0..L-1]
    dc = z[..., :1].real + z[..., :1].imag            # X[0] = Re+Im of Z[0]
    nyq = z[..., :1].real - z[..., :1].imag           # X[L] = Re-Im of Z[0]
    if packed:
        return torch.cat([torch.complex(dc, nyq), full[..., 1:]], dim=-1)
    zero = torch.zeros_like(dc)
    return torch.cat([torch.complex(dc, zero), full[..., 1:],
                      torch.complex(nyq, zero)], dim=-1)


def rfft_spec(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """Batched R2C spec: real (..., N) -> complex (..., N/2+1), or packed
    (..., N/2)."""
    n = x.shape[-1]
    return _split_forward(fft_stockham(pack_real(x)), n, packed)


def _merge_inverse(spec: torch.Tensor, n: int, packed: bool) -> torch.Tensor:
    """Pre-process the real spectrum back into the half-size complex
    spectrum Z."""
    L = n // 2
    dc = spec[..., :1].real
    nyq = spec[..., :1].imag if packed else spec[..., L:L + 1].real
    body = spec[..., 1:L]
    x_half = torch.cat([torch.complex(dc, torch.zeros_like(dc)), body],
                       dim=-1)                                  # X[0..L-1]
    # mirror[k] = X[L-k]: for k = 0 that is X[L] (Nyquist)
    mirror = torch.cat([torch.complex(nyq, torch.zeros_like(nyq)),
                        torch.flip(body, [-1])], dim=-1)
    winv = _const(np.exp(+2j * np.pi * np.arange(L) / n), spec)
    e = 0.5 * (x_half + torch.conj(mirror))
    o = 0.5 * (x_half - torch.conj(mirror)) * winv
    return e + 1j * o


def irfft_spec(spec: torch.Tensor, n: int, packed: bool = False,
               normalize: bool = False) -> torch.Tensor:
    """Batched C2R spec.  Returns (N/2)*x unless ``normalize`` (reference
    contract)."""
    zi = fft_stockham(_merge_inverse(spec, n, packed), inverse=True)
    out = torch.stack([zi.real, zi.imag], dim=-1).reshape(
        spec.shape[:-1] + (n,))
    if normalize:
        out = out / (n // 2)
    return out


def packed_to_numpy_layout(spec_packed: torch.Tensor) -> torch.Tensor:
    """The reference's packed L-slot layout -> numpy's (L+1) layout."""
    dc = spec_packed[..., :1].real
    nyq = spec_packed[..., :1].imag
    zero = torch.zeros_like(dc)
    return torch.cat([torch.complex(dc, zero), spec_packed[..., 1:],
                      torch.complex(nyq, zero)], dim=-1)


def numpy_to_packed_layout(spec: torch.Tensor) -> torch.Tensor:
    """numpy's (L+1) rfft layout -> the reference's packed L-slot layout."""
    head = torch.complex(spec[..., :1].real, spec[..., -1:].real)
    return torch.cat([head, spec[..., 1:-1]], dim=-1)
