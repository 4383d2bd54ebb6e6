"""harmonic_bytes: the bytes a step's harmonic sum moves through device
memory, in GiB: the rise of the program's counter ``harmonic_bytes()``
(the bytes that ``harmonic_sum``'s device passes read and write: on the
card the spectrum read, the interbinned power Q with whatever copies of it
the passes hand on, and its partial sums, written and read once, the SNR
written) over the window, over its steps.  The spectrum read and the SNR
written alone are 8 GiB a step in ``hsum.h32.n2e23``; what the passes
hand on through device memory counts twice.  The counter is read from the
module that holds the launch counters (the configuration's
``launch_counts``); None where that module has no such counter."""

import importlib

GIB = float(1 << 30)


def _counter(run):
    module = run.cell.config["program"]["launch_counts"].partition(":")[0]
    return getattr(importlib.import_module(module), "harmonic_bytes", None)


def start(run):
    counter = _counter(run)
    run.scratch["harmonic_before"] = None if counter is None else counter()


def stop(run):
    counter = _counter(run)
    run.scratch["harmonic_after"] = None if counter is None else counter()


def read(run):
    before = run.scratch.get("harmonic_before")
    after = run.scratch.get("harmonic_after")
    if before is None or after is None:
        return None
    return (after - before) / run.steps / GIB
