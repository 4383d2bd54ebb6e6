"""Plain reference of ``accel_search``: each DM trial's spectrum and its
f-zdot power plane against the acceleration templates.

``expected`` is float64 and plain ``torch``, nothing of the program: the
spectrum is ``torch.fft.rfft`` of each trial (numpy layout, L = n/2 + 1
bins, zero outside them); the template of drift z, for q = -w .. w, w =
ceil(ZMAX / 2) + 16, is

    A_z(q) = (1/S) sum_{s<S} exp(2 pi i [(z/2) u_s^2 - (z/2 + q) u_s]),

u_s = (s + 1/2) / S, S = 2^20, evaluated as one length-S DFT a template;
the plane is the correlation summed over q directly, bin by bin, with no
overlap-save:

    P[t, j, r] = |sum_q X_t[r + q] conj(A_{z_j}(q))|^2,  r = 0 .. L - 1.

``control`` puts the reference in the program's place one precision below
the configuration's float32: bfloat16 input, spectrum and plane (each
computed in float64 between the roundings).  TF32 is off for the products.
"""

from __future__ import annotations

import math

import torch

#: the configuration's grid (its ``accel_plane`` call's zmax and dz)
ZMAX, DZ = 200, 2
S = 1 << 20
EDGE = 16
_banks: dict = {}


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def templates(zmax: float, dz: float, device) -> torch.Tensor:
    """complex128 (m, 2w + 1): A_{z_j}(q), q = -w .. w, z_j = -zmax + j
    dz; cached per (zmax, dz, device)."""
    key = (zmax, dz, str(device))
    if key in _banks:
        return _banks[key]
    w = math.ceil(zmax / 2) + EDGE
    u = (torch.arange(S, dtype=torch.float64, device=device) + 0.5) / S
    q = torch.arange(-w, w + 1, device=device)
    tilt = torch.polar(torch.ones(2 * w + 1, dtype=torch.float64,
                                  device=device),
                       -math.pi * q.to(torch.float64) / S)
    rows = []
    for j in range(round(2 * zmax / dz) + 1):
        turns = ((-zmax + j * dz) / 2) * (u * u - u)
        c = torch.polar(torch.ones_like(u),
                        2 * math.pi * (turns - torch.round(turns)))
        rows.append(torch.fft.fft(c)[q % S] * tilt / S)
    _banks[key] = torch.stack(rows)
    return _banks[key]


def plane(spec: torch.Tensor, bins_a_product: int = 1 << 15) -> torch.Tensor:
    """(T, L) spectra -> float64 (T, m, L) power plane: the sum over q as
    products of (bins, 2w + 1) windows of the zero-padded spectrum by the
    conjugate bank."""
    _no_tf32()
    a = templates(ZMAX, DZ, spec.device)
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
            y = xp[i, r0:r1 + k - 1].unfold(0, k, 1) @ ah
            out[i, :, r0:r1] = (y.real.square() + y.imag.square()).T
    return out


def expected(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Rows of the input -> the exact outputs of the step, by name."""
    spec = torch.fft.rfft(x.to(torch.float64), dim=-1)
    return {"rfft_large": spec, "plane": plane(spec)}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """A float or complex tensor with each part rounded to bfloat16, as
    float32 or complex64."""
    if not t.is_complex():
        return t.to(torch.bfloat16).to(torch.float32)
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


def control(x: torch.Tensor, traffic: dict) -> dict[str, torch.Tensor]:
    """The step's outputs from the reference in bfloat16 storage."""
    spec = _bf16(torch.fft.rfft(_bf16(x).to(torch.float64), dim=-1))
    return {"rfft_large": spec, "plane": _bf16(plane(spec))}
