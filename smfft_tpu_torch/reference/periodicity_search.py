"""Plain reference of the periodicity-search deployment: the R2C of each
dedispersed DM trial, as AstroAccelerate's periodicity search and its
Fourier-domain acceleration search start (SKA1 PSS: 2^23 float32 samples a
trial, 536.87 s at 64 us; Dimoudi et al. 2018, ApJS 239, 28).

The float64 library transform is an independent oracle here: it shares no
code with the port's passes or split, and rounds 2^29 times finer than
float32.
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor) -> torch.Tensor:
    """(trials, n) real -> (trials, n/2 + 1) complex128: each trial's
    spectrum in numpy's layout, unnormalized."""
    return torch.fft.rfft(x.to(torch.float64), dim=-1)
