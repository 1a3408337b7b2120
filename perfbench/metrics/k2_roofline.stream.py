"""100 x the least time of K2's work (``atdn::corr_lookup``: the in-bound
taps of the pyramid for the coordinates, the coordinates read, the
windows written) over its device time per call in the traced slice. The
coordinates are the last traced frame's final ones (its low-resolution
flow on the pixel grid), which the 12 lookups of a frame approach."""

from perfbench.core import roofline


def read(run):
    op = run.trace.ops.get("atdn::corr_lookup") if run.trace else None
    if not op or op[1] <= 0:
        return None
    cfg, f = run.cell.config, run.cell.config["flow"]
    hw8 = (cfg["image_height"] // 8, cfg["image_width"] // 8)
    moved = roofline.corr_lookup(hw8, f["corr_levels"], f["corr_radius"], f["compute_dtype"],
                                 run.extra.get("k2_coords"))
    least = roofline.bound_s(*moved, f["compute_dtype"])
    return 100.0 * least / (op[1] / op[0])
