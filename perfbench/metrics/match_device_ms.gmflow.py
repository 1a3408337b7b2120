"""Device ms per frame of the kernels launched inside the program's
``atdn::gmflow.match`` and ``atdn::gmflow.propagate`` spans (GMFlow's
global matching and propagation, float32 K5 over every token) in the
traced slice; None where the program records neither span, or on a
device without a timeline."""


def read(run):
    if run.trace is None:
        return None
    seconds = sum(run.trace.ops.get(name, (0, 0.0))[1] for name in ("atdn::gmflow.match", "atdn::gmflow.propagate"))
    if not seconds:
        return None
    return seconds * 1e3 / run.trace.units
