"""The device's timeline over the measured window, from ``torch.profiler``.

Only the CUDA activity is traced (kernels, copies and sets on the card),
so the host path carries no per-operation profiler hooks.  Every time is
read on the profiler's own clock, in nanoseconds: an idle gap is named by
the device operations on either side of it, not by host marks.
"""

from __future__ import annotations

import dataclasses

import torch

from h100bench import stats


@dataclasses.dataclass
class Timeline:
    """Every device operation in the window, and the window on the
    profiler's clock."""
    ops: list[tuple[str, int, int]]       # (name, start ns, end ns)
    start_ns: int
    end_ns: int

    @property
    def busy(self) -> list[tuple[int, int]]:
        return stats.union([(a, b) for _, a, b in self.ops], self.start_ns,
                           self.end_ns)

    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy)

    def op_ns(self) -> int:
        """The summed duration of every device operation (overlaps counted
        twice)."""
        return sum(b - a for _, a, b in self.ops)

    def by_name(self) -> list[tuple[str, int]]:
        """Device time by operation name, the largest first."""
        out: dict[str, int] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0) + (b - a)
        return sorted(out.items(), key=lambda kv: -kv[1])

    def idle_between(self) -> list[tuple[str, int]]:
        """The window's idle device time, summed by the operations on
        either side of each gap ("<before> -> <after>", with "window start"
        and "window end" at the edges), the largest first."""
        out: dict[str, int] = {}
        t, before = self.start_ns, "window start"
        for name, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if a > t:
                key = f"{before} -> {name}"
                out[key] = out.get(key, 0) + (a - t)
            if b >= t:
                t, before = b, name
        if self.end_ns > t:
            key = f"{before} -> window end"
            out[key] = out.get(key, 0) + (self.end_ns - t)
        return sorted(out.items(), key=lambda kv: -kv[1])


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespace and
    argument list ("c2c_kernel<1024, false>"); other operations' names
    ("Memcpy DtoD (Device -> Device)") as they are."""
    if not name.startswith("void "):
        return name[:120]
    name = name[5:].replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


class Profile:
    """``with Profile("cuda"): ...`` traces the card; ``timeline(lo, hi)``
    then gives its operations, ``lo`` and ``hi`` the window in wall-clock
    ns.  On the CPU (the harness's tests) it traces the host, and the
    timeline holds no device operation."""

    def __init__(self, device: str):
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if device == "cuda" else act.CPU])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def timeline(self, start_ns: int, end_ns: int) -> Timeline:
        cuda = torch.autograd.DeviceType.CUDA
        ops = [(short_name(e.name()), e.start_ns(), e.end_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        return Timeline(ops, start_ns, end_ns)
