"""The card's idle time over a traced window, put down to what the host was
doing: for the readers ``idle_api_ms``, ``idle_op_ms``, ``idle_launch_ms``
and ``idle_caller_ms`` (and their ``.blocks``).

Each library call of the program launches one kernel, and a cell's window
runs one stream from one thread, so the k-th ``launch:*`` span of the
window (``spans.py``) is the k-th operation of the device timeline, both in
start order.  The program names the ``__global__`` each launch span runs
(``smfft_tpu_torch.ops._cuda.LAUNCHED``), and each pair has to agree by
name (the profiler's ``<function><template arguments>``).  No pair is
matched by time: the spans are on ``time.time_ns``'s clock, the device's
operations on the profiler's, which drifts from it.

The window's idle time is the device timeline's: ``[start_ns, end_ns)``
less the union of its operations, as ``device_idle`` reads it.  A gap
that ends where a kernel K starts is measured on the device clock alone,
g = start(K) - the end of what ran before it (or the window's start), and
laid back onto the host's clock as [e - g, e], e the end of K's launch
span: the library call has returned and K is queued, so the device waited
on whatever the host did in the time before.  Each instant of that image
goes to the innermost program span on the launching thread:

  * ``call:*``: the API;
  * ``op:*``, and a child of an op that is not a launch (``copy``): the op;
  * ``launch:*`` with its ``alloc``, ``tables`` and ``call``: the launch;
  * no span: the caller (the synchronize's return, the benchmark's loop).

The gap after the last kernel, and the part of an image outside the
window, go to the caller, so the four sum to the window's idle time.
Where the launches and the device operations do not pair up (their counts
differ, or a pair disagrees by name), or there is no device operation, no
record, or no name from the program, there is no split: a wrong match is
never read as one.
"""

from __future__ import annotations

import importlib

import numpy as np

from h100bench import spans, stats

#: the layers an idle instant is put down to, in the split's order
LAYERS = ("api", "op", "launch", "caller")
_API, _OP, _LAUNCH, _CALLER = range(4)


def launched() -> dict | None:
    """The program's ``launch:<kernel>`` span name -> ``__global__``; None
    where the program does not name them."""
    try:
        names = importlib.import_module("smfft_tpu_torch.ops._cuda")
    except ImportError:
        return None
    return getattr(names, "LAUNCHED", None)


def runs(op_name: str, function: str) -> bool:
    """Whether the device operation ``op_name`` is the kernel ``function``
    (``c2c_kernel`` is not ``c2c_multiple_kernel<...>``)."""
    return op_name.startswith(function + "<")


def match(rec, lo: int, hi: int, ops, names: dict):
    """The indices of the launch spans that returned in the window, in
    start order, one for each of ``ops`` (sorted by start); None where
    they do not pair up."""
    idx = np.flatnonzero(rec.kind("launch:") & (rec.end > lo)
                         & (rec.end <= hi))
    idx = idx[np.argsort(rec.start[idx], kind="stable")]
    if len(idx) != len(ops):
        return None
    for i, (op_name, _, _) in zip(idx.tolist(), ops):
        function = names.get(rec.names[rec.name[i]])
        if function is None or not runs(op_name, function):
            return None
    return idx


def gaps(ops, lo: int, hi: int) -> tuple[list[tuple[int, int]], int]:
    """The window's idle time on the device clock: (the index in ``ops``,
    sorted by start, of the kernel that ends each gap, its length) for each
    gap that a kernel ends, and the idle time after the last one."""
    first = {}
    for k, (_, a, _) in enumerate(ops):
        first.setdefault(a, k)
    out, t = [], lo
    for a, b in stats.union([(a, b) for _, a, b in ops], lo, hi):
        if a > t:
            out.append((first[a], a - t))
        t = b
    return out, hi - t


def _layer_of(rec) -> np.ndarray:
    """Each span's layer: its own for ``call:``, ``op:`` and ``launch:``,
    else its parent's (a root of no layer: the op's)."""
    own = np.full(len(rec), -1, np.int64)
    for prefix, layer in (("call:", _API), ("op:", _OP),
                          ("launch:", _LAUNCH)):
        own[rec.kind(prefix)] = layer
    layer, parent = own.tolist(), rec.parent.tolist()
    for i, p in enumerate(parent):     # a parent comes before its spans
        if layer[i] < 0:
            layer[i] = layer[p] if p >= 0 else _OP
    return np.array(layer, np.int64)


class _Pieces:
    """One thread's host time cut into pieces, each with the layer of the
    innermost span over it (the caller where none is)."""

    def __init__(self, starts, ends, layers):
        cuts, kinds = [], []
        stack: list[int] = []
        t = None

        def piece(until, layer):
            nonlocal t
            if t is not None and until > t:
                cuts.append(t)
                kinds.append(layer)
            t = until if t is None else max(t, until)

        for i in range(len(starts)):
            while stack and ends[stack[-1]] <= starts[i]:
                top = stack.pop()
                piece(ends[top], layers[top])
            piece(starts[i], layers[stack[-1]] if stack else _CALLER)
            stack.append(i)
        while stack:
            top = stack.pop()
            piece(ends[top], layers[top])
        self.cuts = np.array(cuts + ([t] if t is not None else []), np.int64)
        self.kinds = np.array(kinds, np.int64)
        before = np.zeros((4, len(self.cuts)), np.int64)
        width = np.diff(self.cuts)
        for layer in range(4):
            before[layer, 1:] = np.cumsum(np.where(self.kinds == layer,
                                                   width, 0))
        self.before = before

    def upto(self, t: np.ndarray) -> np.ndarray:
        """(4, len(t)): the time of each layer in the pieces before each
        instant of ``t``."""
        out = np.zeros((4, len(t)), np.int64)
        if len(self.cuts) < 2:
            return out
        last = len(self.cuts) - 1
        j = np.searchsorted(self.cuts, t, side="right") - 1
        inside = (j >= 0) & (j < last)
        out[:, j >= last] = self.before[:, last][:, None]
        ji = j[inside]
        out[:, inside] = self.before[:, ji]
        out[self.kinds[ji], np.flatnonzero(inside)] += t[inside] - \
            self.cuts[ji]
        return out


def split_ns(rec, lo: int, hi: int, ops, names: dict) -> dict | None:
    """``{layer: ns}`` over the window (``LAYERS``), summing to its idle
    time; None where the launches and ``ops`` do not pair up or there is no
    device operation."""
    ops = sorted(ops, key=lambda o: o[1])
    if not ops:
        return None
    idx = match(rec, lo, hi, ops, names)
    if idx is None:
        return None
    ended, tail = gaps(ops, lo, hi)
    total = np.zeros(4, np.int64)
    total[_CALLER] += tail
    k = np.array([g[0] for g in ended], np.int64)
    g = np.array([g[1] for g in ended], np.int64)
    e = rec.end[idx[k]]
    s = e - g
    a, b = np.maximum(s, lo), np.minimum(e, hi)
    inside = np.maximum(b - a, 0)
    total[_CALLER] += int((g - inside).sum())   # outside the window
    b = np.maximum(a, b)
    layer = _layer_of(rec)
    thread = rec.thread[idx[k]]
    for th in np.unique(thread).tolist():
        on = rec.thread == th
        pieces = _Pieces(rec.start[on].tolist(), rec.end[on].tolist(),
                         layer[on].tolist())
        mine = thread == th
        by_layer = pieces.upto(b[mine]) - pieces.upto(a[mine])
        spanned = by_layer[:_CALLER].sum(axis=1)
        total[:_CALLER] += spanned
        total[_CALLER] += int(inside[mine].sum() - spanned.sum())
    return dict(zip(LAYERS, total.tolist()))


def split(run) -> dict | None:
    """``{layer: ns}`` of the run's traced window (cached in
    ``run.scratch``); None without a split."""
    if "idle_split" not in run.scratch:
        w = spans.window(run)
        names = launched()
        run.scratch["idle_split"] = None if w is None or names is None else \
            split_ns(w[0], w[1], w[2], run.timeline.ops, names)
    return run.scratch["idle_split"]


def reader(layer: str):
    """``read(run)`` of the idle time put down to ``layer``: ms a step."""
    def read(run):
        got = split(run)
        return None if got is None else got[layer] / run.steps / 1e6
    return read
