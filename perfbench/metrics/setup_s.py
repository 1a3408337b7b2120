"""Seconds from the start of the process to the first measured frame or
step: import, the kernels' build on a checkout's first run, weights,
inputs and warm-up (host clock)."""


def read(run):
    return run.setup_s
