"""step_ms.p95: the nearest-rank 95th percentile of every step's time in
the window, each read on the card between a CUDA event recorded before the
step's first call and one recorded after its last (the host's issue of the
calls included, the synchronize's return not)."""

from h100bench import stats


def read(run):
    return stats.percentile(run.step_ms, 95)
