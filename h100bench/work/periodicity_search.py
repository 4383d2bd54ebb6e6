"""Work of one step of ``periodicity_search``: ``rfft_large`` of ``rows``
float32 DM trials of ``n`` samples.

Counted from the shapes, whatever computes the step: the call's input read
once (4n bytes a row) and its output written once (n/2 + 1 complex64 bins,
numpy layout), and 2.5 n log2 n fp32 operations a real transform of n
samples, half the complex count.

``sweep_bytes`` is the floor of one launch of the huge-N path: a four-step
pass or the real split reads and writes the whole complex array of
rows * n/2 points once (8 bytes a point each way), in either packing mode.
"""

from __future__ import annotations

import math


def step_bytes(traffic: dict) -> int:
    rows, n = traffic["rows"], traffic["n"]
    return rows * (4 * n + 8 * (n // 2 + 1))


def step_flops(traffic: dict) -> float:
    rows, n = traffic["rows"], traffic["n"]
    return rows * 2.5 * n * math.log2(n)


def sweep_bytes(traffic: dict) -> int:
    return 8 * traffic["rows"] * traffic["n"]
