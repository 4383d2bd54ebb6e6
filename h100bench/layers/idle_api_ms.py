"""idle_api_ms: the card's idle time that the host spent in the public
calls' own code (a ``call:*`` span innermost: the checks, the precision,
``Function.apply``), from ``h100bench.idle``'s split of the traced window;
ms a step."""

from h100bench import idle, spans

start, stop = spans.start, spans.stop
read = idle.reader("api")
