"""launches_per_step: the kernel launches of the window, by the program's
launch counters (every wrapper's ``count``, read through the function the
configuration names), over its steps."""

from h100bench import harness


def _total(run) -> int:
    return sum(harness._attr(run.cell.config["program"]["launch_counts"])()
               .values())


def start(run):
    run.scratch["launches_before"] = _total(run)


def stop(run):
    run.scratch["launches_after"] = _total(run)


def read(run):
    done = run.scratch["launches_after"] - run.scratch["launches_before"]
    return done / run.steps
