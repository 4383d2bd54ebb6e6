"""smfft_tpu_torch — batched small/medium FFTs in PyTorch with a
hand-written Hopper CUDA kernel.

The port of ``smfft_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports no JAX: the JAX package stays beside it as the reference the
port is tested against.

This slice covers batched fp32 power-of-two C2C transforms, N = 32..16384,
forward and inverse, natural or revblock order:

  * :func:`fft`, :func:`ifft`, :func:`ifft_unordered` on complex64
    tensors (``api``);
  * the same three on planar fp32 pairs in :mod:`smfft_tpu_torch.planar`;
  * ``python -m smfft_tpu_torch.verify N nFFTs nRuns inverse reorder``,
    the reference's verification harness.

A CUDA tensor runs the kernel in ``csrc/c2c.cu`` (built with nvcc at first
use); a CPU tensor runs its plain PyTorch version.
"""

from smfft_tpu_torch import planar
from smfft_tpu_torch.api import fft, ifft, ifft_unordered
from smfft_tpu_torch.params import FFTParams, SUPPORTED_C2C_SIZES, plan_for

__version__ = "0.1.0"

__all__ = [
    "FFTParams",
    "SUPPORTED_C2C_SIZES",
    "fft",
    "ifft",
    "ifft_unordered",
    "plan_for",
    "planar",
]
