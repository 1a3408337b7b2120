"""Device milliseconds per frame of the kernels launched inside ATDNVO's
forward (the ``perfbench.atdnvo`` range of the traced slice)."""


def read(run):
    if run.trace is None or not run.trace.ranges.get("atdnvo"):
        return None
    return run.trace.ranges["atdnvo"] * 1e3 / run.trace.units
