"""The comparison that decides ``correct``.

Each sampled step's outputs are held against the configuration's plain
reference, computed from the step's own input block, in blocks of
``check_rows`` rows.  For each output the number compared is

    <output>_err = max |got - expected| / rms(expected)

over every element of that step's output, and a step passes when each
number is finite and at or below its limit in the traffic file.
"""

from __future__ import annotations

import math

import torch


def readings(reference, x: torch.Tensor, outputs: dict[str, torch.Tensor],
             check_rows: int) -> dict[str, float]:
    """The numbers compared for one step; NaN where an output is missing,
    misshapen or not finite."""
    worst: dict[str, float] = {}
    sumsq: dict[str, float] = {}
    count: dict[str, int] = {}
    for r0 in range(0, x.shape[0], check_rows):
        exp = reference.expected(x[r0:r0 + check_rows])
        for name, e in exp.items():
            got = outputs.get(name)
            if got is None or got.shape[0] != x.shape[0] \
                    or got.shape[1:] != e.shape[1:]:
                worst[name] = math.nan
                continue
            d = (got[r0:r0 + check_rows].to(e.dtype) - e).abs().max().item()
            prev = worst.get(name, 0.0)
            worst[name] = math.nan if math.isnan(d) or math.isnan(prev) \
                else max(prev, d)
            sumsq[name] = sumsq.get(name, 0.0) + e.abs().square().sum().item()
            count[name] = count.get(name, 0) + e.numel()
    out = {}
    for name, d in worst.items():
        rms = math.sqrt(sumsq.get(name, 0.0) / max(count.get(name, 0), 1))
        out[f"{name}_err"] = d / rms if rms > 0 and math.isfinite(d) \
            else math.nan
    return out


def passes(values: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every limited number is present, finite and within its
    limit."""
    return all(name in values and values[name] <= limit
               for name, limit in limits.items())


def judge(per_step: list[dict[str, float]],
          limits: dict[str, float]) -> tuple[dict[str, float], int]:
    """The worst reading of each number over the compared steps (NaN
    counts as the worst) and how many steps failed."""
    worst: dict[str, float] = {}
    for values in per_step:
        for name, v in values.items():
            w = worst.get(name, -math.inf)
            worst[name] = math.nan if math.isnan(v) or math.isnan(w) \
                else max(v, w)
    failed = sum(not passes(v, limits) for v in per_step)
    return worst, failed
