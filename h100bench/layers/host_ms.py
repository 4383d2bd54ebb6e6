"""host_ms: the host time a step spends inside the program's public calls
(``api.py`` and the ``ops`` wrappers, the launch included), from the
benchmark's own span around each call, with no synchronize inside; the
mean over the window's steps, in ms."""


def read(run):
    return run.host_ns / run.steps / 1e6
