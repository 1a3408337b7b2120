"""100 x the least time of K5's work (``atdn::flash_attend``: q, k and v
read, the output written, q k^T and p v) over its device time per call
in the traced slice. Its shapes are the configuration's: (1, H/8 * W/8,
128) q, k and v in the flow net's type."""

from perfbench.core import roofline


def read(run):
    op = run.trace.ops.get("atdn::flash_attend") if run.trace else None
    if not op or op[1] <= 0:
        return None
    cfg, f = run.cell.config, run.cell.config["flow"]
    n = (cfg["image_height"] // 8) * (cfg["image_width"] // 8)
    d = f["dim_head"]
    least = roofline.bound_s(*roofline.flash_attend(n, n, d, d, f["compute_dtype"]), f["compute_dtype"])
    return 100.0 * least / (op[1] / op[0])
