"""The signal layer: linear convolution, the analytic signal, resampling
and spectral analysis on the fused kernels.  The counterpart of
``smfft_tpu/signal.py``, with the same names, signatures and layouts.

Linear (streaming) convolution.  The reference filters long sampled streams
with short filters (convolution through shared-memory FFTs).  Overlap-save
turns the circular transforms into linear convolution: the stream is framed
into a batch of overlapping rows (``unfold``, one copy), the whole batch
goes through one fused convolution kernel (``csrc/conv.cu``: forward
transform, product, inverse transform in one pass), and the valid part of
each frame is stitched back (one reshape and slice).  The filter's own
transform is one more kernel call (the R2C or C2C kernel).
``fftconvolve(x, h)`` matches ``numpy.convolve(x, h)`` ("full" mode) and
``scipy.signal.fftconvolve`` for 1-D signals and batches of them.

``hilbert`` / ``envelope`` are one fused convolution with the one-sided
mask; ``resample`` (scipy.signal.resample) runs on the arbitrary-length
transforms (:mod:`smfft_tpu_torch.bluestein`, ``csrc/chirp.cu``).

Spectral analysis: the reference's home pipeline (the Astro-Accelerate
periodicity search) reads |X_k|^2 of windowed frames.  ``power_spectrum``
runs the one-pass power kernel (``csrc/spectral.cu``: transform, split and
square, window at the load) for 256 <= n <= 4096 in the fp32 tiers, and
``rfft`` and a square elsewhere; ``periodogram`` / ``welch`` /
``spectrogram`` frame the signal (``unfold``), subtract each frame's mean
and scale as scipy does, without the Nyquist bin; ``stft`` / ``istft`` run
the R2C and C2R kernels with windowed overlap-add.
"""

from __future__ import annotations

import numpy as np
import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.bluestein import fft_any, ifft_any
from smfft_tpu_torch.ops import spectral as SP
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES


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


def overlap_save_frames(x: torch.Tensor, k: int, n: int, start: int,
                        length: int) -> tuple[torch.Tensor, int]:
    """Overlap-save framing of rows ``x`` (B, T) for a filter of ``k`` taps
    and frames of ``n`` points: (frames (B * F, n), F).

    Frame f holds the points [f * hop, f * hop + n) of the row padded with
    k - 1 - ``start`` zeros in front and zeros behind (hop = n - k + 1, two
    copies: the padded row, then the frames), so that its circular
    convolution with the taps holds, at positions [k - 1, n), outputs
    ``start`` + f * hop .. ``start`` + f * hop + hop - 1 of the linear
    convolution (output i = sum_j h[j] x[i - j], x zero beyond both ends);
    F frames cover ``length`` outputs.  0 <= ``start`` <= k - 1.
    """
    b, t = x.shape
    hop = n - k + 1
    frames = -(-length // hop)
    left = k - 1 - start
    right = (frames - 1) * hop + n - left - t
    xp = torch.cat([x.new_zeros((b, left)), x[:, :t + min(0, right)],
                    x.new_zeros((b, max(0, right)))], dim=-1)
    return xp.unfold(-1, n, hop).reshape(b * frames, n), frames


def overlap_save_valid(y: torch.Tensor, b: int, frames: int,
                       k: int) -> torch.Tensor:
    """The convolved frames of :func:`overlap_save_frames` (..., B * F, n)
    -> each frame's valid part, circular positions [k - 1, n): a view
    (..., B, F, hop) of ``y``, frame f of row r holding outputs start +
    f * hop .. start + f * hop + hop - 1 of row r."""
    return y.reshape(y.shape[:-2] + (b, frames, y.shape[-1]))[..., k - 1:]


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
    full_len = t + k - 1

    real = not x.is_complex() and not h.is_complex()
    if real:
        x = api._as_real(x)
    dt = x.dtype if real else torch.complex64
    fx, frames = overlap_save_frames(x.to(dt), k, n, 0, full_len)

    if real:
        hf = api.rfft(_pad_taps(h, n, real=True), backend=backend,
                      precision=precision)[0]
        y = api.convolve_real(fx, hf, backend=backend, precision=precision)
    else:
        hf = api.fft(_pad_taps(h, n, real=False), backend=backend,
                     precision=precision)[0]
        y = api.convolve(fx, hf, backend=backend, precision=precision)
    y = overlap_save_valid(y, b, frames, k)
    y = y.reshape(b, frames * (n - k + 1))[:, :full_len]
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


def hilbert(x: torch.Tensor, backend: str = "auto",
            precision: str | None = None) -> torch.Tensor:
    """Analytic signal of real rows (scipy.signal.hilbert): complex (..., n)
    whose real part is ``x`` and whose imaginary part is its Hilbert
    transform.

    The one-sided spectral mask [1, 2, ..., 2, 1, 0, ..., 0] is a frequency
    response, so the whole transform is one fused forward transform, mask
    and inverse (:func:`smfft_tpu_torch.api.convolve`, ``csrc/conv.cu``),
    and keeps its gradient."""
    n = x.shape[-1]
    if n not in SUPPORTED_C2C_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}; supported: "
                         f"{SUPPORTED_C2C_SIZES}")
    if x.is_complex():
        raise ValueError("hilbert expects real input rows")
    mask = np.zeros(n, np.float32)
    mask[0] = 1.0
    mask[1:n // 2] = 2.0
    mask[n // 2] = 1.0
    h = torch.from_numpy(mask).to(device=x.device, dtype=torch.complex64)
    return api.convolve(x.to(torch.complex64), h, backend=backend,
                        precision=precision)


def envelope(x: torch.Tensor, backend: str = "auto",
             precision: str | None = None) -> torch.Tensor:
    """Amplitude envelope ``|hilbert(x)|`` of real rows (float32)."""
    return hilbert(x, backend=backend, precision=precision).abs()


def resample(x: torch.Tensor, num: int, axis: int = -1,
             backend: str = "auto",
             precision: str | None = None) -> torch.Tensor:
    """Fourier-domain resampling (scipy.signal.resample) of real or complex
    rows from n to ``num`` samples along ``axis``.

    Both lengths may be any size 1..8192: supported powers of two run the
    C2C kernel, every other size the one-pass Bluestein kernel
    (:func:`smfft_tpu_torch.bluestein.fft_any`).  scipy's band-limited
    interpolation: truncate or zero-pad the centered spectrum, halve the
    split Nyquist bin, scale by num/n.  The scale (the raw inverse's 1/n)
    rides the gather's weights."""
    moved = axis not in (-1, x.dim() - 1)
    if moved:
        x = x.transpose(axis, -1)
    n = x.shape[-1]
    was_real = not x.is_complex()
    spec = fft_any(x.to(torch.complex64), backend=backend,
                   precision=precision)
    m = min(n, num)
    m2 = m // 2 + 1
    # the centered spectrum surgery as one (num,) gather times weights
    # (scipy's two-sided path): out bin k takes in bin src[k] times w[k]
    src = np.zeros(num, np.int64)
    w = np.zeros(num, np.float64)
    src[:m2] = np.arange(m2)
    w[:m2] = 1.0
    if m2 < m:                           # negative-frequency block
        src[num - (m - m2):] = np.arange(n - (m - m2), n)
        w[num - (m - m2):] = 1.0
    fold = m % 2 == 0 and num < n       # unpaired bin at m//2
    if m % 2 == 0 and n < num:          # upsample: split the bin
        w[m // 2] = 0.5
        src[num - m // 2] = m // 2
        w[num - m // 2] = 0.5
    dev = spec.device
    out = spec[..., torch.from_numpy(src).to(dev)] * torch.from_numpy(
        (w / n).astype(np.float32)).to(dev)
    if fold:
        # downsample: unite the +/- pair into the new Nyquist bin
        out[..., m // 2] += spec[..., n - m // 2] * np.float32(1.0 / n)
    y = ifft_any(out, backend=backend, precision=precision, norm=None)
    y = y.real if was_real else y
    return y.transpose(axis, -1) if moved else y


# ---------------------------------------------------------------------------
# Spectral analysis: windows, power spectra, periodogram / Welch / STFT /
# spectrogram.
# ---------------------------------------------------------------------------


def get_window(window, n: int, periodic: bool = True) -> torch.Tensor:
    """Window vector of length ``n`` (float32).

    ``window``: "boxcar" | "hann" | "hamming" | "blackman" | "bartlett", a
    ("kaiser", beta) tuple, or an array (numpy or torch) of shape (n,),
    which passes through.  ``periodic=True`` gives the DFT-even form used
    for spectral estimation (scipy's fftbins=True)."""
    if isinstance(window, (torch.Tensor, np.ndarray)):
        w = torch.as_tensor(window).to(torch.float32)
        if tuple(w.shape) != (n,):
            raise ValueError(f"window array must have shape ({n},), "
                             f"got {tuple(w.shape)}")
        return w
    m = n if periodic else n - 1
    j = np.arange(n, dtype=np.float64)
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, ()
    if name == "boxcar":
        w = np.ones(n)
    elif name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * j / m)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * j / m)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * j / m)
             + 0.08 * np.cos(4 * np.pi * j / m))
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * j / m - 1.0)
    elif name == "kaiser":
        beta = float(args[0]) if args else 8.6
        w = np.i0(beta * np.sqrt(np.clip(
            1.0 - (2.0 * j / m - 1.0) ** 2, 0.0, None))) / np.i0(beta)
    else:
        raise ValueError(f"unknown window {window!r}")
    return torch.from_numpy(w.astype(np.float32))


def power_spectrum(x: torch.Tensor, window: torch.Tensor | None = None,
                   backend: str = "auto",
                   precision: str | None = None) -> torch.Tensor:
    """One-sided power spectrum of real rows: (..., n) -> float32
    (..., n/2), slot 0 = DC^2, slot k = |X_k|^2.

    The Nyquist bin is omitted (the packed slot-0 convention, see
    ``ops/spectral.py``).  For 256 <= n <= 4096 in the fp32 tiers this is
    one pass of the power kernel (6 bytes of device memory a sample, the
    window multiplied in at the load); ``precision="exact"``, n = 8192 /
    16384 and ``backend="spec"`` run ``rfft`` and a square."""
    n = x.shape[-1]
    if n not in SUPPORTED_REAL_SIZES or n < 256:
        raise ValueError(
            f"Error wrong FFT length! N={n}; power_spectrum supports "
            f"{[s for s in SUPPORTED_REAL_SIZES if s >= 256]}")
    exact = api._exact(precision)
    api._check_backend(backend)
    if window is not None:
        window = torch.as_tensor(window).to(device=x.device,
                                             dtype=torch.float32)
    if backend == "auto" and SP.MIN_N <= n <= SP.MAX_N and not exact:
        out = SP.power_pencil_planar(x.reshape(-1, n), n, window=window)
        return out.reshape(x.shape[:-1] + (n // 2,))
    xw = x if window is None else x * window
    spec = api.rfft(xw, backend=backend, precision=precision)
    return (spec.real.square() + spec.imag.square())[..., :n // 2].to(
        torch.float32)


def _spectral_scale(window: torch.Tensor, fs: float,
                    scaling: str) -> tuple[float, float]:
    """(all-bin factor, one-sided doubling factor) for scipy parity, from
    the window on the host (a window on the card is copied back)."""
    w = window.detach().cpu().double().numpy()
    if scaling == "density":
        base = 1.0 / (fs * float(np.sum(w * w)))
    elif scaling == "spectrum":
        base = 1.0 / float(np.sum(w)) ** 2
    else:
        raise ValueError("scaling must be 'density' or 'spectrum'")
    return base, 2.0 * base


def _scale_onesided(pw: torch.Tensor, base: float,
                    double: float) -> torch.Tensor:
    """scipy's one-sided scaling: the DC bin gets base, bins 1.. get 2*base
    (the Nyquist bin, which would also get base, is omitted)."""
    scale = torch.full((pw.shape[-1],), np.float32(double), device=pw.device)
    scale[0] = float(np.float32(base))
    return pw * scale


def _freqs(n: int, fs: float, device: torch.device) -> torch.Tensor:
    """rfftfreq(n, 1/fs) without the Nyquist bin, float32."""
    return torch.from_numpy(np.fft.rfftfreq(n, 1.0 / fs)[:n // 2].astype(
        np.float32)).to(device)


def _detrend(x: torch.Tensor, detrend) -> torch.Tensor:
    """scipy's detrend="constant" (subtract each row's mean) or none."""
    if detrend == "constant":
        return x - x.mean(dim=-1, keepdim=True)
    if detrend not in (False, None):
        raise ValueError("detrend must be 'constant' or False")
    return x


def periodogram(x: torch.Tensor, fs: float = 1.0, window="boxcar",
                detrend: str | bool = "constant", scaling: str = "density",
                backend: str = "auto", precision: str | None = None):
    """scipy.signal.periodogram over the power kernel.

    Returns (freqs (n/2,), Pxx (..., n/2)): scipy's layout without the
    Nyquist bin (see :func:`power_spectrum`).  ``detrend="constant"``
    subtracts each row's mean (scipy's default)."""
    n = x.shape[-1]
    w = get_window(window, n)
    base, double = _spectral_scale(w, fs, scaling)
    pw = power_spectrum(_detrend(x, detrend), window=w, backend=backend,
                        precision=precision)
    return _freqs(n, fs, x.device), _scale_onesided(pw, base, double)


def _frame(x: torch.Tensor, nperseg: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., F, nperseg) full frames (the partial tail is
    dropped): a view (``unfold``)."""
    t = x.shape[-1]
    if t < nperseg:
        raise ValueError(f"signal length {t} < frame length {nperseg}")
    return x.unfold(-1, nperseg, hop)


def welch(x: torch.Tensor, fs: float = 1.0, window="hann",
          nperseg: int = 1024, noverlap: int | None = None,
          detrend: str | bool = "constant", scaling: str = "density",
          backend: str = "auto", precision: str | None = None):
    """scipy.signal.welch over the power kernel: the mean of windowed
    per-frame periodograms.  Returns (freqs (nperseg/2,), Pxx (...,
    nperseg/2)): scipy's layout without the Nyquist bin."""
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap={noverlap} must be in [0, {nperseg})")
    fx = _detrend(_frame(x, nperseg, nperseg - noverlap), detrend)
    w = get_window(window, nperseg)
    base, double = _spectral_scale(w, fs, scaling)
    pw = power_spectrum(fx, window=w, backend=backend, precision=precision)
    return (_freqs(nperseg, fs, x.device),
            _scale_onesided(pw.mean(dim=-2), base, double))


def spectrogram(x: torch.Tensor, fs: float = 1.0, window="hann",
                nperseg: int = 1024, noverlap: int | None = None,
                scaling: str = "density", backend: str = "auto",
                precision: str | None = None):
    """Power spectrogram: per-frame scaled periodograms (Welch without the
    mean).  Returns (freqs (nperseg/2,), times (F,), Sxx (..., F,
    nperseg/2))."""
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    fx = _detrend(_frame(x, nperseg, hop), "constant")
    w = get_window(window, nperseg)
    base, double = _spectral_scale(w, fs, scaling)
    pw = power_spectrum(fx, window=w, backend=backend, precision=precision)
    frames = fx.shape[-2]
    times = torch.from_numpy(((np.arange(frames) * hop + nperseg / 2) / fs)
                             .astype(np.float32)).to(x.device)
    return (_freqs(nperseg, fs, x.device), times,
            _scale_onesided(pw, base, double))


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int | None = None,
         window="hann", backend: str = "auto",
         precision: str | None = None) -> torch.Tensor:
    """Short-time Fourier transform: (..., T) real -> (..., F, n_fft/2+1)
    complex (numpy rfft layout per frame, Nyquist bin included).

    Frames start at multiples of ``hop_length`` (default n_fft//4), with no
    centering or padding: frame f covers samples [f*hop, f*hop + n_fft).
    The windowed frames go through the R2C kernel in one batch."""
    hop = hop_length or n_fft // 4
    fx = _frame(x, n_fft, hop)
    w = get_window(window, n_fft).to(x.device)
    return api.rfft(fx * w, backend=backend, precision=precision)


def istft(z: torch.Tensor, n_fft: int = 1024,
          hop_length: int | None = None, window="hann",
          length: int | None = None, backend: str = "auto",
          precision: str | None = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add (the least-squares inverse with
    the same window; exact for COLA windows such as hann at hop n_fft//4
    or n_fft//2).

    ``z``: (..., F, n_fft/2+1) complex frames from :func:`stft`.  Returns
    (..., T) real with T = (F-1)*hop + n_fft (or ``length``)."""
    hop = hop_length or n_fft // 4
    w = get_window(window, n_fft)
    frames = z.shape[-2]
    t_full = (frames - 1) * hop + n_fft
    y = api.irfft(z, n=n_fft, backend=backend,
                  precision=precision) * w.to(z.device)  # (..., F, n_fft)
    # overlap-add with one index_add_; window-square normalization
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).reshape(-1)
    batch_shape = z.shape[:-2]
    out = torch.zeros(batch_shape + (t_full,), dtype=y.dtype,
                      device=z.device)
    out.index_add_(-1, torch.from_numpy(idx).to(z.device),
                   y.reshape(batch_shape + (frames * n_fft,)))
    wsq = np.zeros(t_full, np.float64)
    np.add.at(wsq, idx, np.tile(w.cpu().double().numpy() ** 2, frames))
    out = out / torch.from_numpy(
        np.maximum(wsq, 1e-12).astype(np.float32)).to(z.device)
    return out if length is None else out[..., :length]
