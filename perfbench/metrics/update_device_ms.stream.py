"""Device ms per frame of the kernels launched inside the program's
``atdn::flow.update`` spans (the flow net's 12 iterations: K2's lookup,
the attention's aggregate and the update block) in the traced slice;
None where the program records no such span, or on a device without a
timeline."""


def read(run):
    if run.trace is None:
        return None
    _, seconds = run.trace.ops.get("atdn::flow.update", (0, 0.0))
    if not seconds:
        return None
    return seconds * 1e3 / run.trace.units
