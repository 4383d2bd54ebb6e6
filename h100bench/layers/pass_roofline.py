"""pass_roofline: the huge-N path's launches against their floor, in %.

Each device operation of the traced window whose kernel is
``fourstep_pass_kernel`` (a four-step pass) or ``real_huge_kernel`` (the
real split or merge) reads and writes at least the whole complex array of
the call once: ``sweep_bytes`` of the cell's work module.  The metric is
the count of those operations times ``sweep_bytes`` over the peak
bandwidth, over their summed device time.  It tells a slow pass from a
plan with too many passes, which ``kernel_roofline`` (the public call's
bytes alone) mixes.  None where no such operation ran or the work module
has no ``sweep_bytes``."""

from h100bench import peaks

KERNELS = ("fourstep_pass_kernel<", "real_huge_kernel<")


def read(run):
    sweep = getattr(run.cell.work, "sweep_bytes", None)
    if run.timeline is None or sweep is None:
        return None
    times = [b - a for name, a, b in run.timeline.ops
             if name.startswith(KERNELS)]
    if not times:
        return None
    floor_s = len(times) * sweep(run.cell.traffic) / peaks.BYTES_PER_S
    return 100.0 * floor_s / (sum(times) / 1e9)
