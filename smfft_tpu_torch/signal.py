"""Linear (streaming) convolution on top of the fused circular kernels.

The reference filters long sampled streams with short filters
(convolution through shared-memory FFTs).  Overlap-save turns the
circular transforms into linear convolution: the stream is framed into a
batch of overlapping rows (``unfold``, one copy), the whole batch goes
through one fused convolution kernel (``csrc/conv.cu``: forward transform,
product, inverse transform in one pass), and the valid part of each frame
is stitched back (one reshape and slice).  The filter's own transform is
one more kernel call (the R2C or C2C kernel).

``fftconvolve(x, h)`` matches ``numpy.convolve(x, h)`` ("full" mode) and
``scipy.signal.fftconvolve`` for 1-D signals and batches of them; the
counterpart of ``smfft_tpu/signal.py``'s functions of the same names.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES


def _pick_nfft(k: int) -> int:
    """Smallest supported FFT size with hop >= 3/4 n (so the per-frame K-1
    overlap re-read stays under a third of the stream traffic)."""
    for n in SUPPORTED_C2C_SIZES:
        if n >= 256 and n - k + 1 >= (3 * n) // 4:
            return n
    raise ValueError(
        f"filter too long for overlap-save: K={k} needs 4*(K-1) <= "
        f"{SUPPORTED_C2C_SIZES[-1]}")


def _pad_taps(h: torch.Tensor, n: int, real: bool) -> torch.Tensor:
    """Taps (K,) -> one zero-padded row (1, n): float32 for the real path,
    complex64 otherwise."""
    dt = torch.float32 if real else torch.complex64
    row = torch.zeros((1, n), dtype=dt, device=h.device)
    row[0, :h.shape[-1]] = h.to(dt)
    return row


def fftconvolve(x: torch.Tensor, h: torch.Tensor, mode: str = "full",
                n_fft: int | None = None, backend: str = "auto",
                precision: str | None = None) -> torch.Tensor:
    """Linear convolution of (batched) signals with a short filter by
    overlap-save over the fused circular convolution.

    Args:
      x: (T,) or (B, T) signal(s): real for the real path (half the
        traffic), complex for the complex path.
      h: (K,) time-domain filter taps (real for the real path).
      mode: "full" (T+K-1 outputs, numpy.convolve's default), "same" (T,
        centered) or "valid" (T-K+1).
      n_fft: frame length; by default the smallest supported size with at
        least 3/4 useful hop.
      backend / precision: passed to the convolution.
    """
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    k = int(h.shape[-1])
    if h.dim() != 1:
        raise ValueError(f"filter must be 1-D taps, got shape "
                         f"{tuple(h.shape)}")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    if x.dim() != 2:
        raise ValueError(f"signal must be (T,) or (B, T), got "
                         f"{tuple(x.shape)}")
    b, t = x.shape
    n = n_fft or _pick_nfft(k)
    if n not in SUPPORTED_C2C_SIZES or n < 256 or k >= n:
        raise ValueError(f"n_fft={n} unsupported or not longer than the "
                         f"filter (K={k})")
    hop = n - k + 1
    full_len = t + k - 1
    frames = -(-full_len // hop)

    real = not x.is_complex() and not h.is_complex()
    # overlap-save: frame f covers padded positions [f*hop, f*hop + n);
    # left-pad K-1 (the linear convolution's warm-up), right-pad to the
    # frame grid
    pad_r = (frames - 1) * hop + n - (k - 1) - t
    dt = x.dtype if real else torch.complex64
    xp = torch.cat([torch.zeros((b, k - 1), dtype=dt, device=x.device),
                    x.to(dt),
                    torch.zeros((b, max(0, pad_r)), dtype=dt,
                                device=x.device)], dim=-1)
    fx = xp.unfold(-1, n, hop).reshape(b * frames, n)  # (B*F, n)

    if real:
        hf = api.rfft(_pad_taps(h, n, real=True), backend=backend,
                      precision=precision)[0]
        y = api.convolve_real(fx, hf, backend=backend, precision=precision)
    else:
        hf = api.fft(_pad_taps(h, n, real=False), backend=backend,
                     precision=precision)[0]
        y = api.convolve(fx, hf, backend=backend, precision=precision)
    # each frame's valid region: circular positions [K-1, n) are the linear
    # convolution's outputs f*hop .. f*hop + hop - 1
    y = y.reshape(b, frames, n)[:, :, k - 1:]
    y = y.reshape(b, frames * hop)[:, :full_len]
    if mode == "same":
        start = (k - 1) // 2
        y = y[:, start:start + t]
    elif mode == "valid":
        y = y[:, k - 1:t]
    return y[0] if squeeze else y


#: scipy.signal.fftconvolve and scipy.signal.oaconvolve agree for 1-D
#: inputs; the overlap-save framing above covers both names.
oaconvolve = fftconvolve


def fftcorrelate(x: torch.Tensor, h: torch.Tensor, mode: str = "full",
                 n_fft: int | None = None, backend: str = "auto",
                 precision: str | None = None) -> torch.Tensor:
    """Linear cross-correlation (``scipy.signal.correlate`` semantics,
    ``method="fft"``): ``correlate(x, h) = convolve(x, conj(h[::-1]))``,
    on the same overlap-save path as :func:`fftconvolve`.

    ``mode="same"`` matches scipy (centered on the x grid); "valid" needs
    ``len(x) >= len(h)``.
    """
    hr = torch.flip(h, [-1])
    if hr.is_complex():
        hr = hr.conj()
    y = fftconvolve(x, hr, mode="full", n_fft=n_fft, backend=backend,
                    precision=precision)
    k = int(h.shape[-1])
    t = x.shape[-1]
    if mode == "full":
        return y
    if mode == "same":
        start = (k - 1) // 2
        return y[..., start:start + t]
    if mode == "valid":
        return y[..., k - 1:t]
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")
