"""Plain reference of ``periodicity_harmonics``: each DM trial's spectrum
and the best SNR of its interbinned power summed over 32 harmonics.

``expected`` is float64 and plain ``torch``, nothing of the program: the
spectrum X is ``torch.fft.rfft`` of each trial (numpy layout, L = n/2 + 1
bins); with M = 2L - 1, straight from the formulas,

    Q[2k] = |X_k|^2,  Q[2k + 1] = (pi^2 / 16) |X_k - X_{k+1}|^2,
    mu, sigma = mean and population standard deviation of Q's M points,
    H_max(0) = 32,  H_max(i) = min(32, (M - 1) // i),
    S_H(i) = sum_{h=1..H} Q[h i],  SNR_H(i) = (S_H(i) - H mu) / (sqrt(H) sigma),
    snr[i] = max over H = 1 .. H_max(i) of SNR_H(i),

each S_H the previous one plus the gather Q[H i], masked where H >
H_max(i).

``control`` puts the reference in the program's place one precision below
the configuration's float32: bfloat16 input, spectrum and SNR (each
computed in float64 between the roundings).
"""

from __future__ import annotations

import math

import torch

#: the configuration's ``harmonic_sum`` call's harmonics
HARMONICS = 32


def snr(spec: torch.Tensor, harmonics: int = HARMONICS) -> torch.Tensor:
    """(T, L) spectra -> float64 (T, 2L - 1) best SNR over the harmonic
    counts."""
    spec = spec.to(torch.complex128)
    t, bins = spec.shape
    m = 2 * bins - 1
    q = torch.empty((t, m), dtype=torch.float64, device=spec.device)
    q[:, 0::2] = spec.abs().square()
    q[:, 1::2] = (math.pi ** 2 / 16) * (spec[:, :-1] - spec[:, 1:]).abs() \
        .square()
    mu = q.mean(-1, keepdim=True)
    sigma = q.std(-1, correction=0, keepdim=True)
    i = torch.arange(m, device=q.device)
    hmax = torch.where(i == 0, harmonics,
                       torch.clamp((m - 1) // i.clamp(min=1), max=harmonics))
    s = torch.zeros_like(q)
    best = torch.full_like(q, -math.inf)
    for h in range(1, harmonics + 1):
        valid = hmax >= h
        s += torch.where(valid, q[:, (h * i).clamp(max=m - 1)], 0.0)
        v = (s - h * mu) / (math.sqrt(h) * sigma)
        best = torch.where(valid & (v > best), v, best)
    return best


def expected(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Rows of the input -> the exact outputs of the step, by name."""
    spec = torch.fft.rfft(x.to(torch.float64), dim=-1)
    return {"rfft_large": spec, "snr": snr(spec)}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """A float or complex tensor with each part rounded to bfloat16, as
    float32 or complex64."""
    if not t.is_complex():
        return t.to(torch.bfloat16).to(torch.float32)
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


def control(x: torch.Tensor, traffic: dict) -> dict[str, torch.Tensor]:
    """The step's outputs from the reference in bfloat16 storage, computed
    ``check_rows`` trials at a time (a whole call's float64 passes would
    not fit beside the window's outputs)."""
    rows, n = x.shape
    spec = torch.empty((rows, n // 2 + 1), dtype=torch.complex64,
                       device=x.device)
    out = torch.empty((rows, n + 1), dtype=torch.float32, device=x.device)
    k = traffic["check_rows"]
    for r0 in range(0, rows, k):
        s = _bf16(torch.fft.rfft(_bf16(x[r0:r0 + k]).to(torch.float64),
                                 dim=-1))
        spec[r0:r0 + k] = s
        out[r0:r0 + k] = _bf16(snr(s))
    return {"rfft_large": spec, "snr": out}
