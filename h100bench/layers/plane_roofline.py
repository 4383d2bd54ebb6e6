"""plane_roofline: the acceleration plane's device time against its floor,
in %.

The floor is ``plane_floor_s`` of the cell's work module: the least time
of the ``accel_plane`` call at the published peaks, from its shapes alone
(the spectrum read and the plane written, or the overlap-save operations,
whichever takes longer), times the window's steps.  The device time is
every device operation of the traced window that is not one of
``rfft_large``'s (``fourstep_pass_kernel``, ``real_huge_kernel``), summed:
the bank's convolution, the framing, crop and power passes, and any kernel
that computes the plane instead of them.  None where no such operation ran
or the work module has no ``plane_floor_s``."""

RFFT_LARGE = ("fourstep_pass_kernel<", "real_huge_kernel<")


def read(run):
    floor = getattr(run.cell.work, "plane_floor_s", None)
    if run.timeline is None or floor is None:
        return None
    times = [b - a for name, a, b in run.timeline.ops
             if not name.startswith(RFFT_LARGE)]
    if not times:
        return None
    return 100.0 * floor(run.cell.traffic) * run.steps / (sum(times) / 1e9)
