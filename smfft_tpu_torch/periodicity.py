"""The periodicity search's harmonic sum: each DM trial's interbinned power
summed over its harmonics to its best SNR.

A pulsar's power spreads over the harmonics of its spin frequency, so a
periodicity search (AstroAccelerate's, Adámek & Armour, "A GPU
implementation of the harmonic sum algorithm", ADASS XXVIII; PRESTO's)
sums, for every fundamental frequency, the power at its first H harmonics
and keeps the best significance over H.  Interbinning (Ransom, Eikenberry
& Middleditch 2002, AJ 124, 1788) fills the half bins first, so that a
signal between two bins loses little power.  For a spectrum X of L bins
(numpy's rfft layout, ``norm="backward"``) and M = 2L - 1:

    Q[2k]     = |X_k|^2,                        k = 0 .. L - 1,
    Q[2k + 1] = (pi^2 / 16) |X_k - X_{k+1}|^2,  k = 0 .. L - 2,

mu and sigma are the mean and population standard deviation of Q's M
points, and for every fundamental i = 0 .. M - 1 (in half bins, so each
harmonic h i is a whole index) and H = 1 .. H_max(i), H_max(0) =
``harmonics``, H_max(i) = min(``harmonics``, (M - 1) // i):

    S_H(i)   = sum_{h=1..H} Q[h i],
    SNR_H(i) = (S_H(i) - H mu) / (sqrt(H) sigma),
    snr[i]   = max_H SNR_H(i),  count[i] = the smallest H attaining it.

On a CUDA spectrum :func:`harmonic_sum` is two launches
(``ops/harmonic.py``, ``csrc/periodicity.cu``) and no other device
operation: ``interbin_kernel`` writes Q and each trial's float64 partial
sums; ``harmonic_sum_kernel`` adds those into mu and sigma and gathers
each fundamental's harmonics from Q.  On a CPU spectrum the plain
versions of the same passes run: the interbinning, the statistics and
the sums.
"""

from __future__ import annotations

import torch

from smfft_tpu_torch import api
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import harmonic as H

#: bytes the harmonic sum's device passes have read and written in this
#: process, counted from the tensors' sizes whether or not recording is on
#: (``parallel.dryrun.harmonic_bytes``): on the card the spectrum read, Q
#: and the partial sums written and read once, the SNR and the counts
#: written; on the CPU each plain pass's reads and writes
moved = 0


def _harmonics(x: torch.Tensor, harmonics: int, exact: bool,
               counts: bool) -> tuple:
    """The op: spectra (T, L) complex64 -> (snr,) or (snr, count)."""
    global moved
    t0 = _T.on and _T.now()
    try:
        if not C.is_cpu(x):
            x = _cuda.contiguous(x)
            q, part = H.launch_interbin(x, exact=exact)
            out = H.launch_harmonic_sum(q, part, harmonics=harmonics,
                                        counts=counts, exact=exact)
            moved += x.nbytes + 2 * (q.nbytes + part.nbytes) + sum(
                o.nbytes for o in out)
            return out
        t = _T.on and _T.now()
        q = H.interbin_plain(x, exact)
        nb = x.nbytes + q.nbytes
        moved += nb
        if t:
            _T.record(t, "interbin", nbytes=nb)
        t = _T.on and _T.now()
        mu, inv_sigma = H.stats_plain(q)
        moved += q.nbytes
        if t:
            _T.record(t, "stats", nbytes=q.nbytes)
        t = _T.on and _T.now()
        out = H.sum_plain(q, mu, inv_sigma, harmonics, counts)
        nb = q.nbytes + sum(o.nbytes for o in out)
        moved += nb
        if t:
            _T.record(t, "sum", nbytes=nb)
        return out
    finally:
        if t0:
            _T.record(t0, "op:harmonic_sum")


@torch.no_grad()
def harmonic_sum(spectrum: torch.Tensor, harmonics: int = 32,
                 precision: str | None = None, return_counts: bool = False):
    """Each spectrum's interbinned power summed over its harmonics to its
    best SNR.

    Args:
      spectrum: complex (T, L) or (L,), L >= 2: each DM trial's spectrum in
        numpy's rfft layout (``rfft_large`` of the trials); complex128 is
        taken as complex64.
      harmonics: the most harmonics a fundamental sums, 1 .. 32.
      precision: the tier, as :func:`~smfft_tpu_torch.fft`: "exact" forms
        Q and the sums in float64, the others in float32; the statistics
        are float64 sums in every tier.
      return_counts: also return, for every fundamental, the smallest
        number of harmonics that attains its best SNR.

    Returns:
      float32 (T, M) (or (M,)), M = 2L - 1: ``snr`` as the module
      describes it, fundamental i at i / 2 bins; with ``return_counts``,
      ``(snr, count)``, the count uint8.  Not differentiable.
    """
    t = _T.on and _T.now()
    x = spectrum
    points = 0
    try:
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        if x.dim() != 2 or not x.is_complex() or x.shape[-1] < 2:
            raise ValueError(f"spectrum must be complex (T, L) or (L,), L >= "
                             f"2, got {tuple(spectrum.shape)} "
                             f"{spectrum.dtype}")
        if isinstance(harmonics, bool) or not isinstance(harmonics, int) \
                or not 1 <= harmonics <= H.MAX_HARMONICS:
            raise ValueError(f"harmonics must be an int in 1..."
                             f"{H.MAX_HARMONICS}, got {harmonics!r}")
        points = 2 * x.shape[-1] - 1
        exact = api._exact(precision)
        out = _harmonics(x.to(torch.complex64), harmonics, exact,
                         return_counts)
        if squeeze:
            out = tuple(o[0] for o in out)
        return out if return_counts else out[0]
    finally:
        if t:
            _T.record(t, "call:harmonic_sum", x, n=points)
