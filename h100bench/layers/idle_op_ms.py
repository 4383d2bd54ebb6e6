"""idle_op_ms: the card's idle time that the host spent in the ops (an
``op:*`` span innermost, or a child of one that is not a launch, such as a
``copy``), from ``h100bench.idle``'s split of the traced window; ms a
step."""

from h100bench import idle, spans

start, stop = spans.start, spans.stop
read = idle.reader("op")
