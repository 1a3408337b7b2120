"""100 x the least time of one unit's operations at the peak of the type
each part computes in, over the measured seconds per unit of the
window (unprofiled). The operations are counted once over the
reference (``core/flops.py``)."""

from perfbench.core.roofline import PEAK_FLOPS


def read(run):
    if not run.flops or not run.units:
        return None
    least = sum(flops / PEAK_FLOPS[kind] for kind, flops in run.flops.items())
    return 100.0 * least / (run.window_s / run.units)
