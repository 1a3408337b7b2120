"""100 x the least time of K5r's work (``atdn::flash_attend_regions``:
q, k, v and the region ids read, the output written, q k^T and p v over
the query-key pairs inside a region, ``core/gmflow.py``) over its device
time per call in the traced slice. Its shapes are the configuration's:
one shifted layer of GMFlow's transformer, both frames' windows."""

from perfbench.core import gmflow, roofline


def read(run):
    op = run.trace.ops.get("atdn::flash_attend_regions") if run.trace else None
    if not op or op[1] <= 0:
        return None
    cfg = run.cell.config
    dtype = cfg["flow"]["compute_dtype"]
    least = roofline.bound_s(*gmflow.k5r_call(cfg), dtype)
    return 100.0 * least / (op[1] / op[0])
