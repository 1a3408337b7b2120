"""Device milliseconds per frame of the kernels launched inside the flow
net's forward (the ``perfbench.flow_net`` range of the traced slice)."""


def read(run):
    if run.trace is None or not run.trace.ranges.get("flow_net"):
        return None
    return run.trace.ranges["flow_net"] * 1e3 / run.trace.units
