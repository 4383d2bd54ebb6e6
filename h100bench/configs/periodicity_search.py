"""Plain reference of ``periodicity_search``: the R2C of each DM trial.

``expected`` is float64 ``torch.fft.rfft`` of each row (numpy layout,
n/2 + 1 bins), nothing of the program.  ``control`` puts the reference in
the program's place one precision below the configuration's float32:
bfloat16 input and spectrum (the transform itself in float32).
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Rows of the input -> the exact outputs of the step, by name."""
    return {"rfft_large": torch.fft.rfft(x.to(torch.float64), dim=-1)}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """A float32 or complex64 tensor with each part rounded to bfloat16."""
    if not t.is_complex():
        return t.to(torch.bfloat16).to(torch.float32)
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


def control(x: torch.Tensor, traffic: dict) -> dict[str, torch.Tensor]:
    """The step's outputs from the reference in bfloat16 storage."""
    return {"rfft_large": _bf16(torch.fft.rfft(_bf16(x), dim=-1))}
