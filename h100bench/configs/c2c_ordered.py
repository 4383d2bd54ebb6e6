"""Plain reference of ``c2c_ordered``: the forward DFT of each row.

``expected`` is float64 ``torch.fft`` (complex128), nothing of the
program.  ``control`` is the same reference put in the program's place one
precision below the configuration's complex64: bfloat16 input and output
(each part rounded to bfloat16; the transform itself in float32), the step
that would halve a memory-bound transform's bytes.
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Rows of the input -> the exact outputs of the step, by name."""
    return {"fft": torch.fft.fft(x.to(torch.complex128), dim=-1)}


def _bf16(z: torch.Tensor) -> torch.Tensor:
    """Each part of a complex64 tensor rounded to bfloat16."""
    r = torch.view_as_real(z).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


def control(x: torch.Tensor, traffic: dict) -> dict[str, torch.Tensor]:
    """The step's outputs from the reference in bfloat16 storage."""
    return {"fft": _bf16(torch.fft.fft(_bf16(x), dim=-1))}
