"""The port's spans: each public call, each op and each kernel launch, with
the host's time on ``time.time_ns``'s clock.

Recording is off at import.  :func:`start` turns it on and :func:`stop`
turns it off and hands out the :class:`Records`; there is no other switch.
Three layers record:

  * ``call:<name>``: each public function of :mod:`smfft_tpu_torch.api`,
    each N-D transform of :mod:`smfft_tpu_torch.ndim` (``fft2``,
    ``ifft2``, ``fftn``, ``ifftn``, ``rfft2``, ``irfft2``, ``rfftn``,
    ``irfftn``), :func:`smfft_tpu_torch.accel.accel_plane` and
    :func:`smfft_tpu_torch.periodicity.harmonic_sum` (``n`` = M, the
    interbinned points a trial), with attributes ``n`` and ``rows`` (the
    product of the leading dims); a call that routes to another public
    call holds it as a child, so an N-D call holds one row call a
    transformed axis;
  * ``op:<name>``: the body of each autograd ``Function.forward`` of
    ``api.py`` and of ``ndim.py``'s column route (``op:column_c2c``), and
    ``op:fft_complex`` for the unordered C2C that bypasses autograd; a call's own time is its checks and ``Function.apply``.  An
    op whose input is not contiguous rows holds a ``copy`` span, with
    ``bytes``: the copy ``ops._cuda.contiguous`` makes before the launch.
    ``op:accel_plane`` holds, on a CUDA spectrum, one
    ``launch:conv_plane`` (the bank's plane form); on a CPU one its plain
    passes as spans with the ``bytes`` each reads and writes: ``frame``
    (the overlap-save framing), the bank's ``call:convolve``, ``crop``
    (each segment's valid part, as |y|, into the plane's layout) and
    ``power`` (the square, in place).  ``op:harmonic_sum`` holds, on a
    CUDA spectrum, ``launch:interbin`` then ``launch:harmonic_sum``; on a
    CPU one the spans ``interbin`` (Q from the spectrum), ``stats`` (its
    mean and deviation) and ``sum`` (the harmonics' sums, the SNR and the
    counts), each with the ``bytes`` it reads and writes;
  * ``launch:<kernel>``: each kernel's launch wrapper in ``ops/*``
    (``kernel`` one of ``parallel.dryrun.KERNELS``), with ``rows``, ``n``,
    ``variant`` (the layout, mode or radix) and ``exact``, and its
    children ``tables`` (the cached device tables; for ``launch:c2c``
    the lookup of its launch plan, or the plan's build on a miss),
    ``alloc`` (the checks and the output's ``torch.empty``, with
    ``bytes``) and ``call`` (``ops._cuda.launch``: the stream, the device
    guard where the device is not the current one, the library call, its
    error check and the kernel's count), each from its start to the next
    one's (the last to the launch's end).  The wrapper's entry reads the
    span's start, reads the clock where each child starts, and records all
    four spans in one call of :func:`launched`.  The C2C wrapper also
    counts the plans it builds, ``launch.plans``: a window's plan hit share
    is ``1 - plans / counts()["c2c"]`` over it (``parallel.dryrun``)::

        sp = trace.on and trace.now()
        a = t = c = out = b = n = 0
        try:
            ...   # checks; b, n = x.shape
            a = sp and trace.now()
            ...   # out = torch.empty(...)
            t = sp and trace.now()
            ...   # the device tables
            c = sp and trace.now()
            _cuda.launch(_cuda.R2C, x.get_device(),
                         ("r2c kernel launch (n={}, batch={}, {})", n, b,
                          layout), x.data_ptr(), ...)
        finally:
            if sp:
                trace.launched(sp, a, t, c, out, "launch:r2c", layout,
                               exact, b, n)

A span site costs, while recording is off, one read of :data:`on` and a
branch at each end; while on, one clock read at its start and one call of
:func:`record` at its end::

    t = trace.on and trace.now()
    try:
        ...
    finally:
        if t:
            trace.record(t, "call:name", x)

A span is one event of twelve int64 words (its name's number, its start,
its end, its thread, its ``rows`` and ``n``; a launch's children's starts,
its output's bytes (a copy's bytes), its variant's number and ``exact``), appended whole to
one flat log under the interpreter's lock, so recording creates no object
the garbage collector tracks; names and variants are numbered once.
:func:`stop` rebuilds the tree thread by thread: a span's parent is the
innermost span that holds it on the same thread (autograd runs CUDA
backward on a thread of its own).  A site that an exception leaves before
its end records nothing, so the call, op and launch sites end in a
``finally``.  Times are ``perf_counter_ns`` while recording; :func:`stop`
moves them onto ``time.time_ns``'s clock, which ``torch.profiler``'s host
events use, by the pair of readings :func:`start` takes.  The card's
operations in the profiler's timeline drift from that clock, so a kernel
is tied to its ``launch:<kernel>`` span by order and by the ``__global__``
that ``ops._cuda.LAUNCHED`` names for the span, never by time: each
library call launches one kernel.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import time

import numpy as np

#: True while recording; every span site reads it first
on = False
#: a span's start (``perf_counter_ns``)
now = time.perf_counter_ns

_ident = threading.get_ident
_log = bytearray()             # the spans, twelve int64 words each
_write = _log.extend
_event = struct.Struct("=12q").pack
_ids: dict[str, int] = {}      # a span's name or a launch's variant -> number
_ids_lock = threading.Lock()
#: the spans with a ``bytes`` attribute: a launch's output allocation, an
#: op's copy, and the plain passes of the acceleration plane and of the
#: harmonic sum
BYTE_SPANS = ("alloc", "copy", "frame", "crop", "power", "interbin", "stats",
              "sum")
_anchor = (0, 0)               # (time.time_ns, perf_counter_ns) at start()
# the words of an event
_KEY, _T0, _T1, _THREAD, _ROWS, _N, _ALLOC, _TABLES, _CALL, _BYTES, \
    _VARIANT, _EXACT = range(12)


def _id(s: str) -> int:
    k = _ids.get(s)
    if k is None:
        with _ids_lock:
            k = _ids.setdefault(s, len(_ids))
    return k


def record(t0: int, name: str, x=None, n: int | None = None,
           nbytes: int = 0) -> None:
    """Record a span of this thread from ``t0`` (a :func:`now` taken while
    recording) to now.  A call passes its input tensor ``x``, whose last
    dim is its ``n`` unless ``n`` is given and whose other dims make its
    ``rows``; a ``copy`` passes the ``nbytes`` it wrote."""
    t1 = now()
    if on:
        k = _ids.get(name)
        if k is None:
            k = _id(name)
        rows = last = 0
        if x is not None:
            try:
                last = x.shape[-1]
                rows = x.numel() // last if last else 0
            except (AttributeError, IndexError, TypeError):
                pass
        _write(_event(k, t0, t1, _ident(), rows, last if n is None else n,
                      0, 0, 0, nbytes, 0, 0))


def launched(t0: int, alloc: int, tables: int, call: int, out, name: str,
             variant: str, exact: bool, rows: int, n: int) -> None:
    """Record a launch from ``t0`` (its entry's :func:`now`) to now, and its
    children from the :func:`now` read where each began (0: none; a launch
    that raised may lack the later ones); ``out`` the output (or a tuple of
    them; 0: none), ``rows`` and ``n`` its shape (0 where a check raised
    before they were read)."""
    t1 = now()
    if on:
        if not alloc:
            nbytes = 0
        elif isinstance(out, tuple):
            nbytes = sum(t.nbytes for t in out)
        else:
            nbytes = getattr(out, "nbytes", 0)
        k, v = _ids.get(name), _ids.get(variant)
        if k is None or v is None:
            k, v = _id(name), _id(variant)
        _write(_event(k, t0, t1, _ident(), rows, n, alloc, tables, call,
                      nbytes, v, 1 if exact else 0))


def _attrs(name: str, rows: int, n: int, nbytes: int, variant: str,
           exact: int) -> dict:
    """A span's attributes by name."""
    if name.startswith("call:"):
        return {"n": n, "rows": rows}
    if name.startswith("launch:"):
        return {"rows": rows, "n": n, "variant": variant,
                "exact": bool(exact)}
    if name in BYTE_SPANS:
        return {"bytes": nbytes}
    return {}


@dataclasses.dataclass
class Records:
    """One recording's spans, one entry of each column a span: thread by
    thread, each thread's in the order they began.  Times are ns on
    ``time.time_ns``'s clock; ``parent`` and ``root`` index the columns
    (``parent`` -1 at a root, ``root`` the span's own index there)."""
    names: list[str]
    attrs: list[dict]
    name: np.ndarray
    attr: np.ndarray
    start: np.ndarray
    end: np.ndarray
    parent: np.ndarray
    root: np.ndarray
    thread: np.ndarray

    def __len__(self) -> int:
        return len(self.start)

    def span(self, i: int) -> dict:
        """Span ``i`` as a dict (for tests and reading by eye)."""
        return {"name": self.names[self.name[i]],
                "start": int(self.start[i]), "end": int(self.end[i]),
                "parent": int(self.parent[i]), "root": int(self.root[i]),
                "thread": int(self.thread[i]),
                "attrs": self.attrs[self.attr[i]]}

    def kind(self, prefix: str) -> np.ndarray:
        """Mask of the spans whose name starts with ``prefix``."""
        hit = np.array([s.startswith(prefix) for s in self.names], bool)
        return hit[self.name] if len(self) else np.zeros(0, bool)


def start() -> None:
    """Turn recording on, with a new pair of clock readings; does nothing
    while recording."""
    global on, _anchor
    if on:
        return
    del _log[:]
    p0 = now()
    wall = time.time_ns()
    _anchor = (wall, (p0 + now()) // 2)
    on = True


def stop() -> Records:
    """Turn recording off and return its records; while off, empty
    records."""
    global on
    if not on:
        return _tree(np.zeros((0, 12), np.int64), 0)
    on = False
    log = np.frombuffer(bytes(_log), np.int64).reshape(-1, 12)
    del _log[:]
    return _tree(_children(log), _anchor[0] - _anchor[1])


def _children(log: np.ndarray) -> np.ndarray:
    """Every span's event: the logged ones and each launch's children, each
    child from its start to the next one's or to the launch's end, with
    ``alloc``'s bytes."""
    rows = [log]
    alloc, tables, call = log[:, _ALLOC], log[:, _TABLES], log[:, _CALL]
    end = log[:, _T1]
    after_tables = np.where(call > 0, call, end)
    after_alloc = np.where(tables > 0, tables, after_tables)
    for name, begin, stop_ in (("alloc", alloc, after_alloc),
                               ("tables", tables, after_tables),
                               ("call", call, end)):
        has = begin > 0
        if not has.any():
            continue
        kid = np.zeros((int(has.sum()), 12), np.int64)
        kid[:, _KEY] = _id(name)
        kid[:, _T0], kid[:, _T1] = begin[has], stop_[has]
        kid[:, _THREAD] = log[has, _THREAD]
        if name == "alloc":
            kid[:, _BYTES] = log[has, _BYTES]
        rows.append(kid)
    return np.concatenate(rows)


def _tree(log: np.ndarray, shift: int) -> Records:
    """The records of the events ``log``: each thread's spans by start (the
    longer first where two start together), each one's parent the
    innermost earlier span that holds it."""
    ids = list(_ids)
    _, thread = np.unique(log[:, _THREAD], return_inverse=True)
    order = np.lexsort((-log[:, _T1], log[:, _T0], thread))
    log = log[order]
    thread = thread.reshape(-1)[order].astype(np.int64)
    parent = np.full(len(log), -1, np.int64)
    root = np.arange(len(log), dtype=np.int64)
    starts, ends = log[:, _T0].tolist(), log[:, _T1].tolist()
    threads = thread.tolist()
    stack: list[int] = []
    for i in range(len(log)):
        while stack and (threads[stack[-1]] != threads[i]
                         or ends[stack[-1]] < ends[i]
                         or ends[stack[-1]] <= starts[i]):
            stack.pop()
        if stack:
            parent[i] = stack[-1]
            root[i] = root[stack[-1]]
        stack.append(i)
    cols = [_KEY, _ROWS, _N, _BYTES, _VARIANT, _EXACT]
    kinds, attr = np.unique(log[:, cols], axis=0, return_inverse=True)
    names: dict[str, int] = {}
    name_of = {k: names.setdefault(ids[k], len(names))
               for k in sorted(set(kinds[:, 0].tolist()))}
    attrs = [_attrs(ids[k], r, n, b, ids[v], e)
             for k, r, n, b, v, e in kinds.tolist()]
    return Records(
        names=list(names), attrs=attrs,
        name=np.array([name_of[k] for k in log[:, _KEY].tolist()], np.int64),
        attr=attr.reshape(-1).astype(np.int64),
        start=log[:, _T0] + shift, end=log[:, _T1] + shift, parent=parent,
        root=root, thread=thread)
