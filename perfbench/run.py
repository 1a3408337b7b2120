#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``atdn_vslam_torch`` once, on the
CUDA devices of this machine:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, limits and metric readers are files under
``perfbench/`` (``core/spec.py``). Set-up (import, the kernels' build
on the first run of a checkout, seeded weights and inputs, warm-up) is
timed from the start of this process to the first measured frame or
step; the window then measures for ``--seconds``. With ``--trace 0`` the
result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a slice run under ``torch.profiler`` after
the window. Once the window has closed the cell's check compares what
the program produced with the plain float32 reference under
``perfbench/reference`` (which imports nothing of the program), and the
numbers compared are printed beside their limits, as the last lines of
standard error and under ``checks`` in the result.

The last line of standard output is the result, one JSON object. The run
exits non-zero and prints no result without a CUDA device, with fewer
devices than the cell asks for, or if ``jax``, ``jaxlib``, ``flax`` or
``atdn_vslam_tpu`` is loaded once the window has closed. The program
builds its kernels inside the checkout (``build/kernels``); the keyframe store
is a directory under the temporary directory, removed at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "atdn_vslam_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None, device: str = "cuda", cell=None) -> int:
    """``device`` and ``cell`` (a ``spec.Cell``) stand in for the card and
    the named cell in the CPU tests."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from perfbench.core import spec
    from perfbench.core.result import verdict
    from perfbench.core.trace import breakdown

    cell = spec.load_cell(args.workload) if cell is None else cell
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
            return 2
    run = spec.runner(cell.traffic).run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)

    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, rows = verdict(run.checks, cell.limits)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    result = {"correct": correct, "attempted": run.units,
              "failed": 0 if correct else run.units, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.wall_s)
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = rows
    print(json.dumps({"cell": args.workload, "seed": args.seed, "setup_s": run.setup_s, "units": run.units,
                      "window_s": run.window_s, "numbers": run.checks,
                      "unit_ms_by_tenth": [1e3 * float(np.median(part)) for part in np.array_split(run.unit_s, 10)
                                           if len(part)],
                      **{k: v for k, v in run.extra.items() if k != "k2_coords"}}))
    for row in rows:
        print(f"check {row['name']} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
