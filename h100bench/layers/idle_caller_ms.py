"""idle_caller_ms: the card's idle time that the host spent outside the
program's spans (the synchronize's return, the loop that calls the
program), with the idle time after the window's last kernel, from
``h100bench.idle``'s split of the traced window; ms a step."""

from h100bench import idle, spans

start, stop = spans.start, spans.stop
read = idle.reader("caller")
