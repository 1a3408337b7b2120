"""100 x the least time of a frame's K5 calls (``atdn::flash_attend``),
each at its own shape and type (``core/gmflow.py``: the unshifted
layers' windows in the flow net's type, the matching and the
propagation over every token in float32), over K5's device time per
frame in the traced slice."""

from perfbench.core import gmflow, roofline


def read(run):
    op = run.trace.ops.get("atdn::flash_attend") if run.trace else None
    if not op or op[1] <= 0:
        return None
    least = sum(roofline.bound_s(b, f, dtype) for b, f, dtype in gmflow.k5_calls(run.cell.config))
    return 100.0 * least / (op[1] / run.trace.units)
