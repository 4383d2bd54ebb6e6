"""Plain reference of the periodicity search's harmonic sum, as
AstroAccelerate computes it for SKA1's pulsar search (Adámek & Armour, "A
GPU implementation of the harmonic sum algorithm", ADASS XXVIII: 32
harmonics on interbinned power, the best SNR over the harmonic counts;
2^23 samples a DM trial, Dimoudi et al. 2018, ApJS 239, 28), with
interbinning as Ransom, Eikenberry & Middleditch 2002 (AJ 124, 1788).

The spectrum X is float64 ``torch.fft.rfft`` of each trial (numpy layout,
L = n/2 + 1 bins).  With M = 2L - 1, straight from the formulas:

    Q[2k] = |X_k|^2,  Q[2k + 1] = (pi^2 / 16) |X_k - X_{k+1}|^2,
    mu, sigma = mean and population standard deviation of Q's M points,
    H_max(0) = harmonics,  H_max(i) = min(harmonics, (M - 1) // i),
    S_H(i) = sum_{h=1..H} Q[h i],  SNR_H(i) = (S_H(i) - H mu) / (sqrt(H) sigma),

for H = 1 .. H_max(i); snr[i] is the largest SNR_H(i) and count[i] the
smallest H that attains it.  Each S_H is the previous one plus the gather
Q[H i], masked where H > H_max(i).

Everything is float64 and plain ``torch``, nothing of the port, and TF32
is off.
"""

from __future__ import annotations

import math

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def spectrum(x: torch.Tensor) -> torch.Tensor:
    """(T, n) real trials -> (T, n/2 + 1) complex128."""
    return torch.fft.rfft(x.to(torch.float64), dim=-1)


def interbin(spec: torch.Tensor) -> torch.Tensor:
    """(T, L) spectra -> float64 (T, 2L - 1) interbinned power Q."""
    spec = spec.to(torch.complex128)
    t, bins = spec.shape
    q = torch.empty((t, 2 * bins - 1), dtype=torch.float64,
                    device=spec.device)
    q[:, 0::2] = spec.abs().square()
    q[:, 1::2] = (math.pi ** 2 / 16) * (spec[:, :-1] - spec[:, 1:]).abs() \
        .square()
    return q


def snrs(spec: torch.Tensor, harmonics: int):
    """Yield (H, valid, SNR_H) for H = 1 .. ``harmonics``: float64 (T, M)
    SNR_H(i), and the bool (M,) mask of the fundamentals with H <=
    H_max(i)."""
    _no_tf32()
    q = interbin(spec)
    m = q.shape[1]
    mu = q.mean(-1, keepdim=True)
    sigma = q.std(-1, correction=0, keepdim=True)
    i = torch.arange(m, device=q.device)
    hmax = torch.where(i == 0, harmonics,
                       torch.clamp((m - 1) // i.clamp(min=1), max=harmonics))
    s = torch.zeros_like(q)
    for h in range(1, harmonics + 1):
        valid = hmax >= h
        s += torch.where(valid, q[:, (h * i).clamp(max=m - 1)], 0.0)
        yield h, valid, (s - h * mu) / (math.sqrt(h) * sigma)


def harmonic_sum(spec: torch.Tensor,
                 harmonics: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, L) spectra -> (snr float64 (T, M), count int64 (T, M))."""
    best = count = None
    for h, valid, v in snrs(spec, harmonics):
        if best is None:
            best, count = v.clone(), torch.ones_like(v, dtype=torch.int64)
            continue
        better = valid & (v > best)
        best = torch.where(better, v, best)
        count = torch.where(better, h, count)
    return best, count


def snr_at(spec: torch.Tensor, harmonics: int,
           count: torch.Tensor) -> torch.Tensor:
    """float64 (T, M): SNR_H(i) at H = ``count[t, i]`` (NaN where that H is
    outside 1 .. H_max(i))."""
    count = count.to(torch.int64)
    out = None
    for h, valid, v in snrs(spec, harmonics):
        if out is None:
            out = torch.full_like(v, math.nan)
        pick = valid & (count == h)
        out = torch.where(pick, v, out)
    return out
