"""Seconds from the process's start to the first timed call: imports, the
kernels' build or load, the frames, the weights and the program's
initialisation, the warm-up."""


def read(run):
    return run.setup_s
