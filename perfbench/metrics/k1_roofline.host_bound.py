"""100 x the least time of K1's work (``atdn::attention_probs``: q and k
read, the padded probabilities written, q k^T) over its device time per
call in the traced slice. Its shapes are the configuration's: one
(1, H/8 * W/8, 128) q and k in the flow net's type."""

from perfbench.core import roofline


def read(run):
    op = run.trace.ops.get("atdn::attention_probs") if run.trace else None
    if not op or op[1] <= 0:
        return None
    cfg = run.cell.config
    n = (cfg["image_height"] // 8) * (cfg["image_width"] // 8)
    dtype = cfg["flow"]["compute_dtype"]
    least = roofline.bound_s(*roofline.attention_probs(n, cfg["flow"]["dim_head"], dtype), dtype)
    return 100.0 * least / (op[1] / op[0])
