"""gbps: the bytes of every step completed in the window (the work
module's count: each public call's input and output tensors) over the
window's wall time, which ends in a synchronize.  GB = 10^9 bytes."""


def read(run):
    return run.steps * run.work_bytes / run.window_s / 1e9
