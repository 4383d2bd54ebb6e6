"""smfft_tpu_torch — batched small/medium FFTs in PyTorch with
hand-written Hopper CUDA kernels.

The port of ``smfft_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports no JAX: the JAX package stays beside it as the reference the
port is tested against.

Seven slices so far:

  * batched fp32 power-of-two C2C transforms, N = 32..16384, forward and
    inverse, natural or revblock order: :func:`fft`, :func:`ifft`,
    :func:`ifft_unordered` on complex64 tensors and the same three on
    planar fp32 pairs in :mod:`smfft_tpu_torch.planar` (``csrc/c2c.cu``),
    with ``python -m smfft_tpu_torch.verify N nFFTs nRuns inverse reorder
    [--kind c2c|r2c|c2r]``, the reference's verification harness;
  * real transforms, N = 64..16384 (``SUPPORTED_REAL_SIZES``):
    :func:`rfft` / :func:`irfft` in numpy layout, :func:`fft_packed_real`
    and packed ``irfft`` in the reference's layout (slot 0 = DC +
    i*Nyquist), and ``planar.rfft`` / ``planar.irfft`` on packed planar
    pairs, natural or revblock (``csrc/real.cu``, ``csrc/c2r.cu``);
  * fused convolution, one pass over memory for a forward transform, a
    filter product and an inverse: :func:`convolve` (complex, one filter
    or a bank), :func:`convolve_real`, ``planar.convolve``, and the
    overlap-save :func:`fftconvolve` / :func:`oaconvolve` /
    :func:`fftcorrelate` for long streams (``csrc/conv.cu``); and the
    reuse loops of ``ops/multiple.py`` (``csrc/multiple.cu``), many
    transforms of data held on chip;
  * the spectral and signal layer and arbitrary lengths: the one-pass
    power spectrum :func:`power_spectrum` (``csrc/spectral.cu``) under
    :func:`periodogram`, :func:`welch`, :func:`spectrogram`, with
    :func:`get_window`, :func:`stft` / :func:`istft`, :func:`hilbert` /
    :func:`envelope`; the DFT of any length n <= 8192 in one pass,
    :func:`fft_any` / :func:`ifft_any` / :func:`rfft_any` /
    :func:`irfft_any` and ``planar.fft_any`` (Bluestein, ``csrc/chirp.cu``),
    :func:`resample` on them, and :func:`czt` / :func:`zoom_fft` on the
    fused convolution;
  * huge N: :func:`fft_large` / :func:`ifft_large` (C2C to 2^28) and
    :func:`rfft_large` / :func:`irfft_large` (real to 2^29), and the same
    four in :mod:`smfft_tpu_torch.planar`, as passes of one four-step
    kernel (``csrc/fourstep.cu``, whose last pass does the pair mode's
    split to radix 256) and a Hermitian split / merge kernel
    (``csrc/real_huge.cu``); on their spectra the Fourier-domain
    acceleration search's power plane, :func:`accel_plane`
    (:mod:`smfft_tpu_torch.accel`: a template bank by overlap-save through
    one launch of the fused convolution bank);
  * N-D transforms and the DCT / DST, composed over the row kernels:
    :func:`fftn` / :func:`ifftn` / :func:`fft2` / :func:`ifft2`,
    :func:`rfft2` / :func:`irfft2` / :func:`rfftn` / :func:`irfftn`,
    :func:`hfft` / :func:`ihfft`, :func:`fftshift` / :func:`ifftshift`,
    :func:`fftfreq` / :func:`rfftfreq` (:mod:`smfft_tpu_torch.ndim`), and
    :func:`dct` / :func:`idct` / :func:`dst` / :func:`idst` of types 1-4
    with :func:`dctn` / :func:`idctn` / :func:`dstn` / :func:`idstn`
    (:mod:`smfft_tpu_torch.dct`);
  * across ranks (:mod:`smfft_tpu_torch.parallel`, on
    ``torch.distributed``): batch sharding (``sharded_fft`` ... over a
    ``DeviceMesh``, ``DTensor`` outputs) and one transform distributed by
    the all-to-all four-step (``distributed_fft`` ... ``distributed_irfft``).

A CUDA tensor runs the kernels (built with nvcc at first use); a CPU
tensor runs their plain PyTorch versions.  ``precision="exact"`` runs the
kernels' fp64-arithmetic instantiation (<= 2 ulp of max|X|).
"""

from smfft_tpu_torch import planar
from smfft_tpu_torch.accel import accel_plane
from smfft_tpu_torch.api import (convolve, convolve_real, fft, fft_large,
                                 fft_packed_real, ifft, ifft_large,
                                 ifft_unordered, irfft, irfft_large, rfft,
                                 rfft_large)
from smfft_tpu_torch.bluestein import (czt, fft_any, ifft_any, irfft_any,
                                       rfft_any, zoom_fft)
from smfft_tpu_torch.dct import (dct, dctn, dst, dstn, idct, idctn, idst,
                                 idstn)
from smfft_tpu_torch.ndim import (fft2, fftfreq, fftn, fftshift, hfft,
                                  ifft2, ifftn, ifftshift, ihfft, irfft2,
                                  irfftn, rfft2, rfftfreq, rfftn)
from smfft_tpu_torch.params import (FFTParams, SUPPORTED_C2C_SIZES,
                                    SUPPORTED_REAL_SIZES, plan_for)
from smfft_tpu_torch.signal import (envelope, fftconvolve, fftcorrelate,
                                    get_window, hilbert, istft, oaconvolve,
                                    periodogram, power_spectrum, resample,
                                    spectrogram, stft, welch)

__version__ = "0.2.0"

__all__ = [
    "FFTParams",
    "SUPPORTED_C2C_SIZES",
    "SUPPORTED_REAL_SIZES",
    "accel_plane",
    "convolve",
    "convolve_real",
    "czt",
    "dct",
    "dctn",
    "dst",
    "dstn",
    "envelope",
    "fft",
    "fft2",
    "fft_any",
    "fft_large",
    "fft_packed_real",
    "fftconvolve",
    "fftcorrelate",
    "fftfreq",
    "fftn",
    "fftshift",
    "get_window",
    "hfft",
    "hilbert",
    "idct",
    "idctn",
    "idst",
    "idstn",
    "ifft",
    "ifft2",
    "ifft_any",
    "ifft_large",
    "ifft_unordered",
    "ifftn",
    "ifftshift",
    "ihfft",
    "irfft",
    "irfft2",
    "irfft_any",
    "irfft_large",
    "irfftn",
    "istft",
    "oaconvolve",
    "periodogram",
    "plan_for",
    "planar",
    "power_spectrum",
    "resample",
    "rfft",
    "rfft2",
    "rfft_any",
    "rfft_large",
    "rfftfreq",
    "rfftn",
    "spectrogram",
    "stft",
    "welch",
    "zoom_fft",
]
