"""setup_s: from process start to the first timed step: imports, the
kernel library's build or load, the inputs made from the seed, and the
warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
