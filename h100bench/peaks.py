"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; the rates
assume the card's full 700 W power limit, which ``device.py`` reads).

The same numbers as ``chip_smoke.py``'s ``PEAK_BYTES_PER_S`` and
``PEAK_FP32_PER_S``, kept here so that a change to the program cannot move
the yardstick.
"""

BYTES_PER_S = 3.35e12      # HBM3
FP32_PER_S = 67e12         # fp32 outside the tensor cores


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for this work, and which of the
    two peaks bounds it ("bytes" or "operations")."""
    by_bytes, by_ops = nbytes / BYTES_PER_S, flops / FP32_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
