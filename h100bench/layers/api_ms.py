"""api_ms: the host time a step spends in the public calls' own code (the
argument checks, the precision, ``Function.apply``), outside their ops:
the time inside root ``call:*`` spans of ``smfft_tpu_torch.trace`` not
covered by the ``op:*`` spans they enclose; the mean over the traced
window's steps, in ms."""

from h100bench import spans

start, stop = spans.start, spans.stop


def read(run):
    host = spans.host(run)
    return None if host is None else host["api_ns"] / run.steps / 1e6
