"""Work of one step of ``real_roundtrip``: ``rfft`` of ``rows`` float32
rows of ``n`` samples, then ``irfft`` of that spectrum.

Counted from the shapes, whatever computes the step: each public call's
input read once and its output written once.  ``rfft`` reads 4n bytes a
row and writes n/2 + 1 complex64 bins (numpy layout); ``irfft`` reads
those bins and writes 4n bytes.  2.5 n log2 n fp32 operations a real
transform of n samples, half the complex count.
"""

from __future__ import annotations

import math


def step_bytes(traffic: dict) -> int:
    rows, n = traffic["rows"], traffic["n"]
    per_call = 4 * n + 8 * (n // 2 + 1)
    return rows * per_call * 2


def step_flops(traffic: dict) -> float:
    rows, n = traffic["rows"], traffic["n"]
    return rows * 2 * 2.5 * n * math.log2(n)
