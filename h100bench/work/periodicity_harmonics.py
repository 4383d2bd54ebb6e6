"""Work of one step of ``periodicity_harmonics``: ``rfft_large`` of ``rows``
float32 DM trials of ``n`` samples, then ``harmonic_sum`` of their spectra
over HARMONICS harmonics.

Counted from the shapes, whatever computes the step.  Bytes: each call's
input read once and its output written once: the trials (4n bytes a row),
the spectrum (n/2 + 1 complex64 bins, written, then read) and the float32
SNR (M = n + 1 interbinned points a row).  Operations: the R2C's 2.5 n
log2 n a trial; the interbinning's 8 a bin (|X_k|^2, and the difference's
square and weight); 4 a harmonic term (its add, the mean taken off, the
scale, the compare) over the terms a trial sums,

    HARMONICS + sum_{h=1..HARMONICS} (M - 1) // h

(fundamental 0 sums HARMONICS terms; fundamental i >= 1 sums min(HARMONICS,
(M - 1) // i), and h counts the fundamentals i >= 1 with h i <= M - 1).

``harmonic_floor_s`` is the least time of the ``harmonic_sum`` call alone
at the published peaks: its bytes (the spectrum read, the SNR written) or
its operations, whichever takes longer.  ``sweep_bytes`` is the floor of
one launch of ``rfft_large``'s huge-N path, as in ``periodicity_search``:
a four-step pass or the real split reads and writes the whole complex array
of rows * n/2 points once (8 bytes a point each way).
"""

from __future__ import annotations

import math

from h100bench import peaks

#: the configuration's ``harmonic_sum`` call's harmonics
HARMONICS = 32


def points(traffic: dict) -> int:
    """M: the interbinned points of a trial."""
    return traffic["n"] + 1


def terms(traffic: dict) -> int:
    """The harmonic terms S_H sums in one trial."""
    m = points(traffic)
    return HARMONICS + sum((m - 1) // h for h in range(1, HARMONICS + 1))


def harmonic_bytes(traffic: dict) -> int:
    bins = traffic["n"] // 2 + 1
    return traffic["rows"] * (8 * bins + 4 * points(traffic))


def harmonic_flops(traffic: dict) -> float:
    bins = traffic["n"] // 2 + 1
    return traffic["rows"] * (8.0 * bins + 4.0 * terms(traffic))


def step_bytes(traffic: dict) -> int:
    rows, n = traffic["rows"], traffic["n"]
    return rows * (4 * n + 8 * (n // 2 + 1)) + harmonic_bytes(traffic)


def step_flops(traffic: dict) -> float:
    rows, n = traffic["rows"], traffic["n"]
    return rows * 2.5 * n * math.log2(n) + harmonic_flops(traffic)


def sweep_bytes(traffic: dict) -> int:
    return 8 * traffic["rows"] * traffic["n"]


def harmonic_floor_s(traffic: dict) -> float:
    return peaks.least_seconds(harmonic_bytes(traffic),
                               harmonic_flops(traffic))[0]
