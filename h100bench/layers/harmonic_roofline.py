"""harmonic_roofline: the harmonic sum's device time against its floor, in
%.

The floor is ``harmonic_floor_s`` of the cell's work module: the least
time of the ``harmonic_sum`` call at the published peaks, from its shapes
alone (the spectrum read and the SNR written, or its operations,
whichever takes longer), times the window's steps.  The device time is
every device operation of the traced window that is not one of
``rfft_large``'s (``fourstep_pass_kernel``, ``real_huge_kernel``), summed:
the interbinning, the harmonic sums, and any kernel that computes them
instead.  None where no such operation ran or the work module has no
``harmonic_floor_s``."""

RFFT_LARGE = ("fourstep_pass_kernel<", "real_huge_kernel<")


def read(run):
    floor = getattr(run.cell.work, "harmonic_floor_s", None)
    if run.timeline is None or floor is None:
        return None
    times = [b - a for name, a, b in run.timeline.ops
             if not name.startswith(RFFT_LARGE)]
    if not times:
        return None
    return 100.0 * floor(run.cell.traffic) * run.steps / (sum(times) / 1e9)
