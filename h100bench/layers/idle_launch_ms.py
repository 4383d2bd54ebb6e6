"""idle_launch_ms: the card's idle time that the host spent in the kernels'
launches (a ``launch:*`` span innermost, or its ``alloc``, ``tables`` or
``call``), from ``h100bench.idle``'s split of the traced window; ms a
step."""

from h100bench import idle, spans

start, stop = spans.start, spans.stop
read = idle.reader("launch")
