"""kernel_roofline: the step's least time on the card over the device time
a step takes, in %.  The least time is max(bytes / peak bandwidth,
operations / peak fp32 rate), with bytes and operations from the cell's
work module (``work/``), never from the kernels; the device time is every
device operation of the traced window, summed, over the window's steps."""

from h100bench import peaks


def read(run):
    if run.timeline is None or not run.timeline.ops:
        return None
    least, _ = peaks.least_seconds(run.work_bytes, run.work_flops)
    per_step = run.timeline.op_ns() / 1e9 / run.steps
    return 100.0 * least / per_step
