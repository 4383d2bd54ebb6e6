"""One-sided power spectrum in one pass: the Hopper kernel's wrapper and its
plain version.

Counterpart of ``smfft_tpu/ops/spectral.py``.  The reference exists to feed
radio-astronomy pipelines (Astro-Accelerate), whose periodicity searches
read |X_k|^2, not spectra.  As ``rfft`` followed by a square that costs a
second pass over the spectrum; the hand-written CUDA kernel
(``csrc/spectral.cu``, ``power_kernel``) fuses the square into the R2C
kernel's pair split, so a real (B, n) block becomes power (B, n/2) in one
pass, 6 bytes a sample (4 in, 2 out) against the rfft's 8.  An optional
window is multiplied in at the load.

Output layout: L = n/2 bins, slot k = |X_k|^2 for k = 1..L-1, slot 0 =
DC^2.  The Nyquist bin is omitted (the packed slot 0 = (DC, Nyquist) leaves
it no slot, and spectral searches discard DC and Nyquist); use ``rfft``
where it matters.  Supported n: 256..4096; the signal layer
(``signal.power_spectrum``) takes ``rfft`` and a square elsewhere.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel
(:func:`launch_power`) or raises; a CPU tensor runs the plain version
(:func:`power_plain`: ``r2c_plain``, then the square), which never calls
``torch.fft``.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R

MIN_N, MAX_N = 256, 4096


def check_size(n: int) -> None:
    """The JAX kernel's size gate (``pencil._check_n(n, 256, 4096)``)."""
    if not MIN_N <= n <= MAX_N or n & (n - 1):
        raise ValueError(
            f"Error wrong FFT length! pencil path supports power-of-two "
            f"{MIN_N} <= n <= {MAX_N}, got {n}")


def power_plain(x: torch.Tensor,
                window: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`launch_power`'s function in plain PyTorch: real (B, n) ->
    (B, n/2), slot 0 = DC^2, slot k = |X_k|^2 of ``rfft(x * window)``."""
    if window is not None:
        x = x * window
    xr, xi = R.r2c_plain(x, "planar")
    # slot 0 of the packed spectrum is (DC, Nyquist): keep DC^2 only
    return torch.cat([xr[:, :1] * xr[:, :1],
                      (xr * xr + xi * xi)[:, 1:]], dim=1)


def launch_power(x: torch.Tensor,
                 window: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``power_kernel`` of ``csrc/spectral.cu`` on the current CUDA
    stream: real float32 (B, n), n = 256..4096, contiguous and 8-byte
    aligned, and an optional float32 window (n,) on the same device ->
    float32 (B, n/2), allocated with ``torch.empty``."""
    sp = _T.on and _T.now()
    a = t = c = out = b = n = 0
    try:
        if x.dim() != 2:
            raise ValueError(f"x must be (batch, n), got {tuple(x.shape)}")
        b, n = x.shape
        check_size(n)
        _cuda.check_rows(x, dtype=torch.float32)
        w_ptr = None
        if window is not None:
            _cuda.check_rows(window.view(1, -1), dtype=torch.float32,
                             width=n, names=("window",))
            if window.device != x.device:
                raise ValueError(f"window is on {window.device}, x on "
                                 f"{x.device}")
            w_ptr = window.data_ptr()
        a = sp and _T.now()
        out = torch.empty((b, n // 2), device=x.device)
        t = sp and _T.now()
        tw = C.device_twiddles(n // 2, False, False, x.device)
        wn = R.split_table(n, False, x.device)
        c = sp and _T.now()
        _cuda.launch(_cuda.POWER, x.get_device(),
                     ("power kernel launch (n={}, batch={})", n, b),
                     x.data_ptr(), w_ptr, out.data_ptr(), b, n,
                     tw.data_ptr(), wn.data_ptr())
    finally:
        if sp:
            _T.launched(sp, a, t, c, out, "launch:power",
                        "plain" if window is None else "window", False, b, n)
    return out


def power_rows(x: torch.Tensor,
               window: torch.Tensor | None = None) -> torch.Tensor:
    """Real (B, n) rows -> power (B, n/2): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if C.is_cpu(x):
        return power_plain(x, window)
    return launch_power(x, window)


def power_pencil_planar(x: torch.Tensor, n: int | None = None,
                        window: torch.Tensor | None = None) -> torch.Tensor:
    """Single-pass one-sided power spectrum: real (B, n) -> float32 (B, n/2),
    slot 0 = DC^2, slot k = |X_k|^2 (Nyquist omitted).  ``window`` (n,) is
    multiplied into each row inside the kernel.  Supported for 256 <= n <=
    4096 (``spectral.power_pencil_planar``)."""
    n = n or x.shape[-1]
    check_size(n)
    if x.shape[-1] != n:
        raise ValueError(f"expected row width {n}, got {x.shape[-1]}")
    rows = x.to(torch.float32).contiguous()
    if window is not None:
        if tuple(window.shape) != (n,):
            raise ValueError(f"window must be shape ({n},), got "
                             f"{tuple(window.shape)}")
        window = window.to(device=rows.device,
                           dtype=torch.float32).contiguous()
    return power_rows(rows, window)
