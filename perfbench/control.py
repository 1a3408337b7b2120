#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, in one
process on the card:

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults half_batch] [--seconds 3] [--out FILE]

For each of ``--seeds`` the cell runs as the benchmark runs it, with a
short window, and prints the numbers its check compares (the program's
readings, whose largest over a dozen seeds is a limit's lower reading).
For each of ``--control-seeds`` it runs again with the control in the
program's place: the reference one step below the precision the
configuration states (``precision``), and each of ``--faults`` (for a
training cell ``half_batch``, the reference on half of each batch).
Their smallest readings are the upper ones. The benchmark's own runs do
not run this. Each reading is one JSON line, and all of them go to
``--out`` too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, device: str = "cuda", cell=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.core import spec

    cell = spec.load_cell(args.workload) if cell is None else cell
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    runner = spec.runner(cell.traffic)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    kinds = ["precision"] + [f for f in args.faults.split(",") if f]
    runs += [(int(s), kind) for s in args.control_seeds.split(",") if s for kind in kinds]
    lines = []
    for seed, kind in runs:
        t0 = time.perf_counter()
        run = runner.run(cell, seed, args.seconds, False, dev, t0, control=kind)
        line = {"workload": args.workload, "seed": seed, "as": kind or "program", **run.checks,
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
