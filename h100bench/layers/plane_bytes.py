"""plane_bytes: the bytes a step's acceleration plane moves through device
memory, in GiB: the rise of the program's counter ``plane_bytes()`` (the
bytes that ``accel_plane``'s device passes read and write: the framing, the
bank's convolution, the crop and the power) over the window, over its
steps.  The plane itself is 4 bytes a bin and template; one pass that reads
the spectrum and writes the plane would read about its size.  The counter
is read from the module that holds the launch counters (the
configuration's ``launch_counts``); None where that module has no such
counter."""

import importlib

GIB = float(1 << 30)


def _counter(run):
    module = run.cell.config["program"]["launch_counts"].partition(":")[0]
    return getattr(importlib.import_module(module), "plane_bytes", None)


def start(run):
    counter = _counter(run)
    run.scratch["plane_before"] = None if counter is None else counter()


def stop(run):
    counter = _counter(run)
    run.scratch["plane_after"] = None if counter is None else counter()


def read(run):
    before = run.scratch.get("plane_before")
    after = run.scratch.get("plane_after")
    if before is None or after is None:
        return None
    return (after - before) / run.steps / GIB
