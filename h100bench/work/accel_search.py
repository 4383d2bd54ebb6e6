"""Work of one step of ``accel_search``: ``rfft_large`` of ``rows`` float32
DM trials of ``n`` samples, then ``accel_plane`` of their spectra against
the configuration's M = 2 ZMAX / DZ + 1 templates of K = 2 (ZMAX/2 + 16) +
1 taps.

Counted from the shapes, whatever computes the step.  Bytes: each call's
input read once and its output written once: the trials (4n bytes a row),
the spectrum (n/2 + 1 complex64 bins, written, then read) and the float32
plane (M (n/2 + 1) a row).  Operations: the R2C's 2.5 n log2 n a trial, and
the plane's overlap-save count at the segment length N = 2048 that makes it
least (per segment one forward transform and M products and inverse
transforms, 5 N log2 N + M (5 N log2 N + 6 N), over ceil((n/2 + 1) / (N -
K + 1)) segments a trial): a lower bound for any FFT-based plane.

``plane_floor_s`` is the least time of the ``accel_plane`` call alone at
the published peaks: its bytes (the spectrum read, the plane written) or
its operations, whichever takes longer.
"""

from __future__ import annotations

import math

from h100bench import peaks

#: the configuration's grid and segment length of the operation count
ZMAX, DZ, EDGE, SEGMENT = 200, 2, 16, 2048


def templates() -> int:
    return round(2 * ZMAX / DZ) + 1


def taps() -> int:
    return 2 * (math.ceil(ZMAX / 2) + EDGE) + 1


def plane_bytes(traffic: dict) -> int:
    bins = traffic["n"] // 2 + 1
    return traffic["rows"] * (8 * bins + 4 * templates() * bins)


def plane_flops(traffic: dict) -> float:
    bins = traffic["n"] // 2 + 1
    segments = -(-bins // (SEGMENT - taps() + 1))
    fft = 5 * SEGMENT * math.log2(SEGMENT)
    return traffic["rows"] * segments * (
        fft + templates() * (fft + 6 * SEGMENT))


def step_bytes(traffic: dict) -> int:
    rows, n = traffic["rows"], traffic["n"]
    return rows * (4 * n + 8 * (n // 2 + 1)) + plane_bytes(traffic)


def step_flops(traffic: dict) -> float:
    rows, n = traffic["rows"], traffic["n"]
    return rows * 2.5 * n * math.log2(n) + plane_flops(traffic)


def plane_floor_s(traffic: dict) -> float:
    return peaks.least_seconds(plane_bytes(traffic),
                               plane_flops(traffic))[0]
