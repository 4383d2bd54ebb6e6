"""The program's own spans over a traced window, for the readers
``api_ms`` and ``op_ms`` (and their ``.blocks``).

``smfft_tpu_torch.trace`` records a span for each public call
(``call:*``), each op (``op:*``) and each kernel launch (``launch:*``, with
its children ``tables``, ``alloc`` and ``call``), on ``time.time_ns``'s
clock, the clock of the profiler's timeline.  Each reader's ``start(run)``
turns recording on just before the window; the first ``stop(run)`` turns
it off and keeps the records in ``run.scratch``.  Untraced runs call no
per-layer reader, so recording stays off there.  A program without the
module (or without spans) gives every reader ``None``.

Everything is read inside the window ``[run.timeline.start_ns,
run.timeline.end_ns)``, spans clipped to it.
"""

from __future__ import annotations

import importlib

import numpy as np

from h100bench import stats


def _trace():
    try:
        return importlib.import_module("smfft_tpu_torch.trace")
    except ModuleNotFoundError:
        return None


def start(run):
    tr = _trace()
    if tr is None or "spans" in run.scratch:
        return
    tr.start()


def stop(run):
    tr = _trace()
    if tr is None or "spans" in run.scratch:
        return
    run.scratch["spans"] = tr.stop()


def window(run):
    """(records, lo, hi, start, end): the records and the window, each
    span's start and end clipped to it; None without records."""
    rec = run.scratch.get("spans")
    if rec is None or run.timeline is None:
        return None
    lo, hi = run.timeline.start_ns, run.timeline.end_ns
    return (rec, lo, hi, np.clip(rec.start, lo, hi),
            np.clip(rec.end, lo, hi))


def host_split(rec, start, end) -> tuple[int, int]:
    """(call self, op) in ns: over each tree of spans (a root and what it
    encloses on its thread), the root's time when it is a ``call:*`` less
    the union of the tree's ``op:*`` spans within it, and that union."""
    is_op = rec.kind("op:")
    is_call = rec.kind("call:")
    ops: dict[int, list] = {}
    for i in np.flatnonzero(is_op & (end > start)):
        ops.setdefault(int(rec.root[i]), []).append(
            (int(start[i]), int(end[i])))
    api = op = 0
    roots = np.flatnonzero(rec.parent < 0)
    for r in roots:
        a, b = int(start[r]), int(end[r])
        u = stats.union(ops.get(int(r), []), -2**62, 2**62)
        op += sum(y - x for x, y in u)
        if is_call[r] and b > a:
            api += (b - a) - sum(y - x for x, y in stats.union(u, a, b))
    return api, op


def host(run) -> dict | None:
    """``{"api_ns", "op_ns"}`` of the window (cached); None without
    records."""
    if "span_host" not in run.scratch:
        w = window(run)
        if w is None or not len(w[0]):
            run.scratch["span_host"] = None
        else:
            api, op = host_split(w[0], w[3], w[4])
            run.scratch["span_host"] = {"api_ns": api, "op_ns": op}
    return run.scratch["span_host"]
