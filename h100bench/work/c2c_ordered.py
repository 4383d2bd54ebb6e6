"""Work of one step of ``c2c_ordered``: one forward C2C of ``rows`` rows of
``n`` complex64 points.

Counted from the shapes, whatever computes the step: each input byte read
once and each output byte written once (8 bytes a complex64 point in, 8
out), and 5 n log2 n fp32 operations a row, the radix-2 count.
"""

from __future__ import annotations

import math


def step_bytes(traffic: dict) -> int:
    rows, n = traffic["rows"], traffic["n"]
    return rows * n * 8 * 2


def step_flops(traffic: dict) -> float:
    rows, n = traffic["rows"], traffic["n"]
    return rows * 5.0 * n * math.log2(n)
