"""device_idle: the share of the traced window in which no operation ran
on the card, in %: 1 minus the union of the device operations' intervals
over the window."""


def read(run):
    if run.timeline is None or not run.timeline.ops:
        return None
    window = run.timeline.end_ns - run.timeline.start_ns
    return 100.0 * (1.0 - run.timeline.busy_ns() / window)
