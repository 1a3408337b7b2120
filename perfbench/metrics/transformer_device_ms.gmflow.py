"""Device ms per frame of the kernels launched inside the program's
``atdn::gmflow.transformer`` span (the position encoding and GMFlow's
six blocks on both frames: the projections, K5 and K5r, the layer norms
and the FFN) in the traced slice; None where the program records no
such span, or on a device without a timeline."""


def read(run):
    if run.trace is None:
        return None
    _, seconds = run.trace.ops.get("atdn::gmflow.transformer", (0, 0.0))
    if not seconds:
        return None
    return seconds * 1e3 / run.trace.units
