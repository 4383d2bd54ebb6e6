"""Fourier-domain acceleration search: the f-ż power plane of each DM
trial's spectrum against a bank of acceleration templates, on the fused
convolution bank.

A pulsar in a binary orbit drifts in frequency while it is observed, and
its power spreads over neighbouring Fourier bins.  The acceleration search
(Ransom, Eikenberry & Middleditch 2002, AJ 124, 1788: PRESTO's
``accelsearch``; on GPUs AstroAccelerate's FDAS, Dimoudi et al. 2018, ApJS
239, 28) correlates each spectrum with the Fourier response of a sinusoid
whose frequency drifts by z bins over the observation, for every z of a
grid, and keeps the power at whole bins:

    P[t, j, r] = |sum_{q=-w}^{w} X_t[r + q] conj(A_{z_j}(q))|^2,

for r = 0 .. L - 1 (X_t a spectrum of L bins, numpy's rfft layout, zero
outside them), z_j = -zmax + j dz for j = 0 .. 2 zmax / dz, and every
template w = ceil(zmax / 2) + 16 bins to each side of its mean bin:

    A_z(q) = (1/S) sum_{s<S} exp(2 pi i [(z/2) u_s^2 - (z/2 + q) u_s]),

u_s = (s + 1/2) / S, S = 2^20: the midpoint rule of the response's integral
over the observation, exactly delta_q0 at z = 0.

:func:`accel_plane` builds the bank on the spectrum's device in float64
once per (zmax, dz, device) (:func:`templates`) and its natural-order
frequency responses once per segment length and tier (:func:`responses`),
then computes the plane by overlap-save in segments of
:func:`choose_nfft`'s length n.

On a CUDA spectrum that is one launch (``ops.convolve.launch_conv_plane``):
the plane form of ``conv_kernel``'s bank in ``csrc/conv.cu``.  Its prologue
reads each segment from the spectrum in place (position p of segment f of
trial t is X_t[f hop + p - left], hop = n - k + 1, left = k - 1 - (k -
1)//2, zero outside the L bins), its forward transform runs once and stays
in registers through the m inverse transforms, and its epilogue stores
|y|^2 of each point p >= k - 1 of inverse j, unrounded and in the tier's
precision, as float32 to bin f hop + p - (k - 1) of the (t, j) row of the
plane, where that bin is below L.  The responses are the CPU path's, the
inverse's 1/n applied to each segment's points as they are read.  No padded row, frame, complex segment
or |y| reaches device memory.  It is an instantiation of its own, beside
the bank's: its output differs in kind (float power at whole bins, not
complex segments), so the bank's callers keep their machine code.

On a CPU spectrum the plane form's plain version runs: the framing
(``signal.overlap_save_frames``), one ``api.convolve`` of the whole bank
(the plain ``conv_kernel`` bank), then |y| of each segment's valid part
into the (trial, template, bin) layout (the ``crop`` pass: ``hypot`` of
the real and imaginary planes) and its square in place (the ``power``
pass).
"""

from __future__ import annotations

import math

import torch

from smfft_tpu_torch import api
from smfft_tpu_torch import trace as _T
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES
from smfft_tpu_torch.signal import overlap_save_frames, overlap_save_valid

#: points of the midpoint rule of each template
S_POINTS = 1 << 20
#: bins each template reaches beyond the half drift zmax / 2
EDGE = 16
#: the s-points summed in one product of the bank's build
_CHUNK = 1 << 14

#: template banks built in this process (``parallel.dryrun.accel_banks``)
built = 0
#: bytes the plane's device passes have read and written in this process,
#: counted from the tensors' sizes whether or not recording is on
#: (``parallel.dryrun.plane_bytes``): on the card the plane form's segments
#: read, its responses once and the plane written; on the CPU the framing,
#: the bank's convolution, the crop and the power
moved = 0

_banks: dict = {}
_responses: dict = {}


def half_width(zmax: float) -> int:
    """w: the bins a template of the grid reaches to each side."""
    return math.ceil(zmax / 2) + EDGE


def z_grid(zmax: float, dz: float) -> list[float]:
    """The drifts z_j = -zmax + j dz, j = 0 .. 2 zmax / dz."""
    if not (zmax >= 0 and dz > 0):
        raise ValueError(f"need zmax >= 0 and dz > 0, got zmax={zmax}, "
                         f"dz={dz}")
    steps = 2 * zmax / dz
    if abs(steps - round(steps)) > 1e-9:
        raise ValueError(f"2 * zmax / dz must be whole, got zmax={zmax}, "
                         f"dz={dz}")
    return [-zmax + j * dz for j in range(round(steps) + 1)]


def _turns(t: torch.Tensor) -> torch.Tensor:
    """exp(2 pi i t) of float64 turns, reduced to the nearest whole turn
    first."""
    t = t - torch.round(t)
    return torch.polar(torch.ones_like(t), 2 * math.pi * t)


def templates(zmax: float, dz: float,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The bank A_{z_j}(q), q = -w .. w: complex128 (m, 2w + 1) on
    ``device``, built once per (zmax, dz, device) and cached.

    The sum over s runs as products of (m, chunk) chirps by (chunk, 2w + 1)
    shifts; a chunk's shifts exp(-2 pi i q u_s) are the first chunk's times
    exp(-2 pi i q s0 / S), s0 its first point."""
    global built
    device = torch.device(device)
    key = (float(zmax), float(dz), device)
    bank = _banks.get(key)
    if bank is not None:
        return bank
    f64 = dict(dtype=torch.float64, device=device)
    z = torch.tensor(z_grid(zmax, dz), **f64)
    w = half_width(zmax)
    q = torch.arange(-w, w + 1, **f64)
    local = (torch.arange(_CHUNK, **f64) + 0.5) / S_POINTS
    shift = _turns(-local[:, None] * q[None, :])         # (chunk, 2w + 1)
    acc = torch.zeros((len(z), 2 * w + 1), dtype=torch.complex128,
                      device=device)
    for s0 in range(0, S_POINTS, _CHUNK):
        u = local + s0 / S_POINTS
        chirp = _turns((z / 2)[:, None] * (u * u - u)[None, :])
        acc += (chirp @ shift) * _turns(-q * (s0 / S_POINTS))
    bank = acc / S_POINTS
    _banks[key] = bank
    built += 1
    return bank


def choose_nfft(k: int) -> int:
    """The segment length for a bank of ``k`` taps: of the C2C sizes from
    256 that are longer than the taps, the one with the fewest fp32
    operations a valid bin, n log2 n / (n - k + 1) (a segment's transforms
    over its hop)."""
    sizes = [n for n in SUPPORTED_C2C_SIZES if n >= 256 and n > k]
    if not sizes:
        raise ValueError(f"a bank of {k} taps needs a segment longer than "
                         f"{SUPPORTED_C2C_SIZES[-1]}")
    return min(sizes, key=lambda n: n * math.log2(n) / (n - k + 1))


def responses(zmax: float, dz: float, n: int, exact: bool,
              device: torch.device | str) -> torch.Tensor:
    """The bank's natural-order frequency responses at segment length
    ``n``: complex (m, n), complex128 for the "exact" tier, else complex64,
    cached per (zmax, dz, n, tier, device).  Row j is the DFT of the taps
    h_j[k] = conj(A_{z_j}(w - k)), k = 0 .. 2w, zero-padded to n, so that
    the linear convolution's output r + w is P's sum at bin r."""
    device = torch.device(device)
    key = (float(zmax), float(dz), n, exact, device)
    h = _responses.get(key)
    if h is None:
        taps = templates(zmax, dz, device).flip(-1).conj()
        k = torch.arange(taps.shape[-1], dtype=torch.int64, device=device)
        f = torch.arange(n, dtype=torch.int64, device=device)
        dft = _turns(-((k[:, None] * f[None, :]) % n).to(torch.float64) / n)
        h = (taps @ dft).to(torch.complex128 if exact else torch.complex64)
        _responses[key] = h
    return h


def _plane(x: torch.Tensor, h: torch.Tensor, k: int,
           precision: str | None) -> torch.Tensor:
    """The op: spectra (T, L) complex64 against responses (m, n) ->
    float32 (T, m, L): on a CUDA spectrum the plane form, on a CPU one its
    plain version, ``h`` from :func:`responses` on both."""
    global moved
    t0 = _T.on and _T.now()
    try:
        rows, bins = x.shape
        m, n = h.shape
        hop = n - k + 1
        if not C.is_cpu(x):
            out = CV.launch_conv_plane(_cuda.contiguous(x), h=h, k=k,
                                       exact=api._exact(precision))
            moved += rows * -(-bins // hop) * n * 8 + h.nbytes + out.nbytes
            return out
        t = _T.on and _T.now()
        fx, frames = overlap_save_frames(x, k, n, (k - 1) // 2, bins)
        # the padded rows: the spectrum read, the row written; the frames
        # read from it and written
        nb = x.nbytes + rows * ((frames - 1) * hop + n) * 8 + 2 * fx.nbytes
        moved += nb
        if t:
            _T.record(t, "frame", nbytes=nb)
        y = api.convolve(fx, h, precision=precision)       # (m, T * F, n)
        moved += fx.nbytes + h.nbytes + y.nbytes
        del fx
        t = _T.on and _T.now()
        # (T, m, F, hop, 2): each segment's valid part, real and imaginary
        valid = torch.view_as_real(
            overlap_save_valid(y, rows, frames, k).transpose(0, 1))
        out = torch.empty((rows, m, bins), dtype=torch.float32,
                          device=x.device)
        # |y| by hypot of the two float planes, one pass into the layout
        # (abs of a complex tensor would go through a complex temporary)
        whole = bins // hop
        if whole:
            v = valid[:, :, :whole]
            torch.hypot(v[..., 0], v[..., 1], out=out[..., :whole * hop]
                        .unflatten(-1, (whole, hop)))
        if bins > whole * hop:
            v = valid[:, :, whole, :bins - whole * hop]
            torch.hypot(v[..., 0], v[..., 1], out=out[..., whole * hop:])
        nb = 3 * out.nbytes                   # 8 bytes read, 4 written
        moved += nb
        if t:
            _T.record(t, "crop", nbytes=nb)
        del y, valid, v
        t = _T.on and _T.now()
        out.square_()
        moved += 2 * out.nbytes
        if t:
            _T.record(t, "power", nbytes=2 * out.nbytes)
        return out
    finally:
        if t0:
            _T.record(t0, "op:accel_plane")


@torch.no_grad()
def accel_plane(spectrum: torch.Tensor, zmax: float = 200, dz: float = 2,
                precision: str | None = None) -> torch.Tensor:
    """The acceleration search's power plane of each spectrum.

    Args:
      spectrum: complex (T, L) or (L,): each DM trial's spectrum in numpy's
        rfft layout (``rfft_large`` of the trials), L bins; complex128 is
        taken as complex64.
      zmax, dz: the drift grid z_j = -zmax + j dz, j = 0 .. 2 zmax / dz
        (PRESTO's -zmax, and its step of 2), each template w = ceil(zmax /
        2) + 16 bins to each side: m = 2 zmax / dz + 1 templates of 2w + 1
        taps.
      precision: the convolution's tier, as :func:`~smfft_tpu_torch.fft`.
        The overlap-save's segments are :func:`choose_nfft`'s (2048 for
        zmax = 200).

    Returns:
      float32 (T, m, L) (or (m, L)): P[t, j, r] as the module describes,
      power at whole bins, unnormalised.  Not differentiable.
    """
    t = _T.on and _T.now()
    x = spectrum
    try:
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        if x.dim() != 2 or not x.is_complex() or x.shape[-1] < 1:
            raise ValueError(f"spectrum must be complex (T, L) or (L,), got "
                             f"{tuple(spectrum.shape)} {spectrum.dtype}")
        z_grid(zmax, dz)
        k = 2 * half_width(zmax) + 1
        n = choose_nfft(k)
        exact = api._exact(precision)
        h = responses(zmax, dz, n, exact, x.device)
        out = _plane(x.to(torch.complex64), h, k, precision)
        return out[0] if squeeze else out
    finally:
        if t:
            _T.record(t, "call:accel_plane", x)
