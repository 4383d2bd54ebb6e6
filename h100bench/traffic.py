"""The one generator of every traffic mix: inputs from the seed, and the
step that a configuration's calls make of them.

A traffic file gives ``n`` (points a row), ``rows`` (rows a call) and
``blocks`` (how many input blocks the closed loop cycles through, in
order); the configuration gives the input's type and range and the chain
of public calls that makes one step.  A call's keyword argument written
``"$key"`` takes the traffic's ``key``.
"""

from __future__ import annotations

import importlib
import time

import torch


def make_inputs(config: dict, traffic: dict, seed: int,
                device: str) -> list[torch.Tensor]:
    """``blocks`` input blocks of (rows, n), made on ``device`` in one call
    from ``seed``: the same seed gives the same inputs."""
    spec = config["input"]
    rows, n, nb = traffic["rows"], traffic["n"], traffic["blocks"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    shape = (nb * rows, n, 2) if spec["dtype"] == "complex64" else (
        nb * rows, n)
    if spec["dtype"] not in ("complex64", "float32"):
        raise ValueError(f"input dtype {spec['dtype']!r}: complex64 or "
                         "float32")
    buf = torch.empty(shape, dtype=torch.float32, device=device)
    buf.uniform_(spec["low"], spec["high"], generator=g)
    x = torch.view_as_complex(buf) if buf.dim() == 3 else buf
    return [x[i * rows:(i + 1) * rows] for i in range(nb)]


def _arg(value, traffic: dict):
    if isinstance(value, str) and value.startswith("$"):
        return traffic[value[1:]]
    return value


class Step:
    """One step: the configuration's calls in order, each fed the named
    output of an earlier one (``"x"`` is the input block).

    Each call's host span (issue to return, no synchronize inside) is kept
    as two ``perf_counter_ns`` marks in ``marks``, named in turn by
    ``span_names``: the benchmark's own span around the call into the
    program's API.
    """

    def __init__(self, config: dict, traffic: dict, api=None):
        if api is None:
            api = importlib.import_module(config["program"]["api"])
        self.calls = [(getattr(api, c["call"]), c["input"], c["output"],
                       {k: _arg(v, traffic)
                        for k, v in c.get("kwargs", {}).items()})
                      for c in config["step"]]
        self.names = [c["output"] for c in config["step"]]
        self.span_names = [c["call"] for c in config["step"]]
        self.marks: list[int] = []

    def __call__(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        values = {"x": x}
        clock, marks = time.perf_counter_ns, self.marks
        for fn, src, dst, kwargs in self.calls:
            t0 = clock()
            values[dst] = fn(values[src], **kwargs)
            marks += (t0, clock())
        del values["x"]
        return values


class Replaced:
    """A step whose outputs come from ``fn(x) -> dict`` instead of the
    program: the control, or a fault planted in a test."""

    def __init__(self, names: list[str], fn):
        self.names, self.fn = names, fn
        self.span_names = ["replaced step"]
        self.marks: list[int] = []

    def __call__(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        t0 = time.perf_counter_ns()
        out = self.fn(x)
        self.marks += (t0, time.perf_counter_ns())
        return out
