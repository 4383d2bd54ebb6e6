"""Plain reference of ``real_roundtrip``: R2C, then C2R of that spectrum.

``expected`` is float64 ``torch.fft.rfft`` of the input for the spectrum,
and the input itself for the round trip (``irfft(rfft(x), n) == x``), so
nothing of the program enters the reference.  ``control`` puts the
reference in the program's place one precision below the configuration's
float32: bfloat16 input, spectrum and output (the transforms themselves
in float32).
"""

from __future__ import annotations

import torch


def expected(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Rows of the input -> the exact outputs of the step, by name."""
    x64 = x.to(torch.float64)
    return {"rfft": torch.fft.rfft(x64, dim=-1), "irfft": x64}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """A float32 or complex64 tensor with each part rounded to bfloat16."""
    if not t.is_complex():
        return t.to(torch.bfloat16).to(torch.float32)
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


def control(x: torch.Tensor, traffic: dict) -> dict[str, torch.Tensor]:
    """The step's outputs from the reference in bfloat16 storage."""
    spec = _bf16(torch.fft.rfft(_bf16(x), dim=-1))
    return {"rfft": spec,
            "irfft": _bf16(torch.fft.irfft(spec, n=traffic["n"], dim=-1))}
