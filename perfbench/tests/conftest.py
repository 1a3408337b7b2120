"""The benchmark's CPU tests: run from the root of the checkout,

    python -m pytest perfbench/tests -q

They shrink a cell to a size the CPU runs in seconds (``tiny_cell``) and
drive it through the harness with ``device="cpu"``, which stands in for
the card: the harness's look for a CUDA device is the one step skipped.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

#: several test workers share the CPU's cores
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the smallest frames at which every pyramid level keeps two rows and columns
TINY_HW = (128, 192)


def shrink(cell):
    from perfbench.core.spec import Cell

    config = copy.deepcopy(cell.config)
    config.update(image_height=TINY_HW[0], image_width=TINY_HW[1])
    config["flow"]["iters"] = 2
    config["train"].update(batch_size=2, sequence_length=3)
    traffic = dict(cell.traffic)
    for key, value in (("pool_frames", 6), ("profile_frames", 2), ("check_samples", 2), ("batches", 3),
                       ("profile_steps", 1), ("crop", list(TINY_HW)), ("batch", 2), ("iters", 2)):
        if key in traffic:
            traffic[key] = value
    return Cell(cell.name, cell.chips, config, traffic, dict(cell.limits), cell.end_to_end, cell.per_layer)


@pytest.fixture
def tiny_cell():
    from perfbench.core.spec import load_cell

    return lambda name: shrink(load_cell(name))
