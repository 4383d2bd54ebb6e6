"""The periodicity search's harmonic sum: the Hopper kernels' wrappers and
their plain versions.

Two hand-written CUDA kernels (``csrc/periodicity.cu``), which replace no
TPU kernel (the JAX package has no harmonic sum):

  * :func:`launch_interbin` — spectra (T, L) complex64 -> the interbinned
    power Q, (T, 2L) (the last point 0, past M = 2L - 1), and each trial's
    32 partial sums and sums of squares of Q in float64;
  * :func:`launch_harmonic_sum` — Q and those partial sums -> float32
    (T, M) ``snr``, each fundamental's best SNR over 1 .. ``harmonics``
    harmonics, and optionally the uint8 count that attains it, the
    harmonics Q[h i] gathered through the read-only path.

A CPU tensor runs the plain versions (:func:`interbin_plain`,
:func:`stats_plain`, :func:`sum_plain`), which repeat the kernels'
arithmetic in the tier's precision: Q and the sums in float32 ("exact":
float64), the statistics in float64.  ``periodicity.harmonic_sum``
chooses by the spectrum's device.
"""

from __future__ import annotations

import math

import torch

from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda

#: the weight of an interbinned point (Ransom et al. 2002): pi^2 / 16
PI2_16 = math.pi ** 2 / 16
#: partial sums a trial that the interbin kernel writes
PARTS = 32
#: the most harmonics a fundamental sums
MAX_HARMONICS = 32


def _real(exact: bool) -> torch.dtype:
    return torch.float64 if exact else torch.float32


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def interbin_plain(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Spectra (T, L) complex64 -> Q (T, 2L) in the tier's precision:
    Q[2k] = |X_k|^2, Q[2k + 1] = (pi^2/16) |X_k - X_{k+1}|^2, the last
    point 0 (the kernel's layout)."""
    rows, bins = x.shape
    rt = _real(exact)
    re, im = x.real.to(rt), x.imag.to(rt)
    q = torch.zeros((rows, 2 * bins), dtype=rt, device=x.device)
    q[:, 0::2] = re * re + im * im
    dr, di = re[:, :-1] - re[:, 1:], im[:, :-1] - im[:, 1:]
    q[:, 1:-1:2] = (dr * dr + di * di) * PI2_16
    return q


def stats_plain(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q from :func:`interbin_plain` -> float64 (T,) mean and 1 /
    population deviation of each row's M = 2L - 1 points, from float64
    sums of Q and Q^2."""
    m = q.shape[1] - 1
    v = q[:, :m].to(torch.float64)
    mu = v.sum(-1) / m
    var = (v * v).sum(-1) / m - mu * mu
    return mu, var.clamp_min(0).sqrt().reciprocal()


def sum_plain(q: torch.Tensor, mu: torch.Tensor, inv_sigma: torch.Tensor,
              harmonics: int, counts: bool = False) -> tuple:
    """Q from :func:`interbin_plain` and its statistics -> (snr,) or (snr,
    count): float32 (T, M) max over H of (S_H - H mu) / sqrt(H), times
    1/sigma, and the smallest H attaining it as uint8, S_H summed in Q's
    precision over h = 1 .. H.  Harmonic h is Q[h i] for the fundamentals
    i <= (M - 1) // h that reach it (fundamental 0 all of them)."""
    rows, m = q.shape[0], q.shape[1] - 1
    rt = q.dtype
    mu_r, inv_r = mu.to(rt)[:, None], inv_sigma.to(rt)[:, None]
    s = torch.zeros((rows, m), dtype=rt, device=q.device)
    best = torch.full((rows, m), -math.inf, dtype=rt, device=q.device)
    arg = torch.zeros((rows, m), dtype=torch.uint8, device=q.device)
    for h in range(1, harmonics + 1):
        k = (m - 1) // h + 1
        sh = s[:, :k]
        sh += q[:, 0:h * (k - 1) + 1:h]
        scale = torch.tensor(float(h), dtype=rt).sqrt().reciprocal()
        d = (sh - h * mu_r) * scale
        better = d > best[:, :k]
        best[:, :k] = torch.where(better, d, best[:, :k])
        arg[:, :k][better] = h
    snr = (best * inv_r).to(torch.float32)
    return (snr, arg) if counts else (snr,)


# ---------------------------------------------------------------------------
# The kernels' launch wrappers.
# ---------------------------------------------------------------------------


def launch_interbin(x: torch.Tensor, *,
                    exact: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``interbin_kernel`` of ``csrc/periodicity.cu`` on the current
    CUDA stream: spectra ``x`` complex64 (T, L), L >= 2 -> (q, part): Q
    (T, 2L) float32 (float64 "exact") as :func:`interbin_plain` gives it,
    and part (T, 32, 2) float64, each run of L/32 bins' sum and sum of
    squares of its Q points."""
    sp = _T.on and _T.now()
    a = c = out = b = n = 0
    try:
        if x.dim() != 2 or x.dtype != torch.complex64 or x.shape[1] < 2:
            raise ValueError(f"x must be complex64 (trials, bins >= 2), got "
                             f"{tuple(x.shape)} {x.dtype}")
        b, n = x.shape
        if 2 * n > 2**31 - 1:
            raise ValueError(f"at most 2^30 - 1 bins, got {n}")
        a = sp and _T.now()
        _cuda.check_rows(x)
        q = torch.empty((b, 2 * n), dtype=_real(exact), device=x.device)
        part = torch.empty((b, PARTS, 2), dtype=torch.float64,
                           device=x.device)
        out = (q, part)
        c = sp and _T.now()
        _cuda.launch(_cuda.INTERBIN, x.get_device(),
                     ("interbin kernel launch (trials={}, bins={})", b, n),
                     x.data_ptr(), q.data_ptr(), part.data_ptr(), b, n,
                     int(exact))
    finally:
        if sp:
            _T.launched(sp, a, 0, c, out, "launch:interbin", "power", exact, b,
                        n)
    return out


def launch_harmonic_sum(q: torch.Tensor, part: torch.Tensor, *,
                        harmonics: int = MAX_HARMONICS, counts: bool = False,
                        exact: bool = False) -> tuple:
    """Launch ``harmonic_sum_kernel`` of ``csrc/periodicity.cu`` on the
    current CUDA stream: q and part from :func:`launch_interbin` at the
    same tier -> (snr,) or (snr, count), as :func:`sum_plain` gives them
    from :func:`stats_plain`'s statistics."""
    sp = _T.on and _T.now()
    a = c = out = b = m = 0
    variant = f"harmonics={harmonics} counts={int(counts)}"
    try:
        if not 1 <= harmonics <= MAX_HARMONICS:
            raise ValueError(f"harmonics must be 1..{MAX_HARMONICS}, got "
                             f"{harmonics}")
        if q.dim() != 2 or q.shape[1] < 4 or q.shape[1] % 2:
            raise ValueError(f"q must be (trials, 2 bins), bins >= 2, got "
                             f"{tuple(q.shape)}")
        b, bins = q.shape[0], q.shape[1] // 2
        m = 2 * bins - 1
        if part.shape != (b, PARTS, 2) or part.dtype != torch.float64 \
                or not part.is_contiguous() or part.device != q.device:
            raise ValueError(f"part must be contiguous float64 ({b}, "
                             f"{PARTS}, 2) beside q, got "
                             f"{tuple(part.shape)} {part.dtype}")
        a = sp and _T.now()
        _cuda.check_rows(q, dtype=_real(exact))
        snr = torch.empty((b, m), dtype=torch.float32, device=q.device)
        count = torch.empty((b, m), dtype=torch.uint8,
                            device=q.device) if counts else None
        out = (snr, count) if counts else (snr,)
        c = sp and _T.now()
        _cuda.launch(_cuda.HARMONIC_SUM, q.get_device(),
                     ("harmonic_sum kernel launch (trials={}, points={}, "
                      "harmonics={})", b, m, harmonics),
                     q.data_ptr(), part.data_ptr(), snr.data_ptr(),
                     count.data_ptr() if counts else None, b, bins,
                     harmonics, int(exact))
    finally:
        if sp:
            _T.launched(sp, a, 0, c, out, "launch:harmonic_sum", variant,
                        exact, b, m)
    return out
