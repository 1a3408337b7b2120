"""100 x the least time of one frame's operations at the peak of the
type each part computes in, over the device's busy seconds a frame
(``frame_device_ms``): the whole step's share of the peak while the
card works, which bounds what the kernels' rooflines can still gain in
that metric. The operations are counted once over the reference
(``core/flops.py``)."""

from perfbench.core.roofline import PEAK_FLOPS


def read(run):
    d = run.device_slice
    if not run.flops or d is None or d.busy_s <= 0:
        return None
    least = sum(flops / PEAK_FLOPS[kind] for kind, flops in run.flops.items())
    return 100.0 * least / (d.busy_s / d.units)
