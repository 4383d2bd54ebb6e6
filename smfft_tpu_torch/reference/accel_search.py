"""Plain reference of the Fourier-domain acceleration search deployment:
each DM trial's spectrum and its f-ż power plane against the acceleration
templates, as AstroAccelerate's FDAS computes it for SKA1's pulsar search
(Dimoudi et al. 2018, ApJS 239, 28: 2^23 samples a trial) with PRESTO's
template bank (Ransom, Eikenberry & Middleditch 2002, AJ 124, 1788: -zmax
200, a step of 2 in z), at whole Fourier bins (no interbinning).

The spectrum X is float64 ``torch.fft.rfft`` of each trial (numpy layout,
L = n/2 + 1 bins, zero outside them).  The template of drift z is, for q =
-w .. w, w = ceil(zmax / 2) + 16,

    A_z(q) = (1/S) sum_{s<S} exp(2 pi i [(z/2) u_s^2 - (z/2 + q) u_s]),

u_s = (s + 1/2) / S, S = 2^20, evaluated here as one length-S DFT a
template: A_z(q) = (1/S) exp(-i pi q / S) DFT_S[c_z](q mod S), c_z[s] =
exp(2 pi i (z/2)(u_s^2 - u_s)).  The plane is the correlation summed over q
directly, bin by bin (no overlap-save, no segments):

    P[t, j, r] = |sum_q X_t[r + q] conj(A_{z_j}(q))|^2,  r = 0 .. L - 1.

Everything is float64 and plain ``torch``, nothing of the port, and TF32
is off for the products.
"""

from __future__ import annotations

import math

import torch

S = 1 << 20
EDGE = 16


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def drifts(zmax: float, dz: float) -> list[float]:
    """z_j = -zmax + j dz, j = 0 .. 2 zmax / dz."""
    return [-zmax + j * dz for j in range(round(2 * zmax / dz) + 1)]


def templates(zmax: float, dz: float, device="cpu") -> torch.Tensor:
    """complex128 (m, 2w + 1): A_{z_j}(q), q = -w .. w."""
    w = math.ceil(zmax / 2) + EDGE
    u = (torch.arange(S, dtype=torch.float64, device=device) + 0.5) / S
    q = torch.arange(-w, w + 1, device=device)
    tilt = torch.polar(torch.ones(2 * w + 1, dtype=torch.float64,
                                  device=device),
                       -math.pi * q.to(torch.float64) / S)
    rows = []
    for z in drifts(zmax, dz):
        turns = (z / 2) * (u * u - u)
        c = torch.polar(torch.ones_like(u),
                        2 * math.pi * (turns - torch.round(turns)))
        rows.append(torch.fft.fft(c)[q % S] * tilt / S)
    return torch.stack(rows)


def spectrum(x: torch.Tensor) -> torch.Tensor:
    """(T, n) real trials -> (T, n/2 + 1) complex128."""
    return torch.fft.rfft(x.to(torch.float64), dim=-1)


def plane(spec: torch.Tensor, zmax: float, dz: float,
          bins_a_product: int = 1 << 15) -> torch.Tensor:
    """(T, L) spectra -> float64 (T, m, L) power plane, the sum over q as
    products of (bins, 2w + 1) windows of the zero-padded spectrum by the
    conjugate bank."""
    _no_tf32()
    a = templates(zmax, dz, spec.device)
    m, k = a.shape
    w = (k - 1) // 2
    t, bins = spec.shape
    spec = spec.to(torch.complex128)
    pad = torch.zeros((t, w), dtype=spec.dtype, device=spec.device)
    xp = torch.cat([pad, spec, pad], dim=-1)
    out = torch.empty((t, m, bins), dtype=torch.float64, device=spec.device)
    ah = a.conj().T
    for i in range(t):
        for r0 in range(0, bins, bins_a_product):
            r1 = min(bins, r0 + bins_a_product)
            win = xp[i, r0:r1 + k - 1].unfold(0, k, 1)    # (r1 - r0, k)
            y = win @ ah
            out[i, :, r0:r1] = (y.real.square() + y.imag.square()).T
    return out
