"""Set-up: process start to the first request of the window (imports,
the kernels' build on a checkout's first run, the weights, the warm-up)."""


def read(run):
    return run.setup_s
