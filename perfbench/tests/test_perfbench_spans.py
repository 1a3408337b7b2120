"""The readers of the program's spans, on a shrunk stream cell on the CPU:
the five host-clock metrics read finite numbers, the device-time ones
read None (the CPU has no device timeline), and every host-clock reader
reads None once the ring has dropped the window's first frame."""

from __future__ import annotations

import copy
import json
import math
import time

import pytest
import torch

from perfbench import run as harness
from perfbench.core import spec

HOST = ("host_step_ms.stream", "host_step_ms.host_bound", "pose_wait_ms.stream", "pose_wait_ms.host_bound",
        "keyframe_ms.stream")
DEVICE = ("update_device_ms.stream", "update_device_ms.host_bound")
SEED = 2**31 + 4242


def _every_frame_a_keyframe(cell):
    cell = copy.deepcopy(cell)
    cell.config["slam"].update(rotation_threshold_deg=0.0, translation_threshold=0.0)
    return cell


@pytest.fixture
def spans_ring():
    from atdn_vslam_torch.utils import profiling

    profiling.clear()
    yield profiling
    profiling.clear()


def test_result_line_holds_the_span_metrics(tiny_cell, capsys, spans_ring):
    name = "cityscapes_stream"
    cell = _every_frame_a_keyframe(tiny_cell(name))
    assert harness.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.5", "--trace", "1"],
                        device="cpu", cell=cell) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    for m in ("host_step_ms.stream", "pose_wait_ms.stream", "keyframe_ms.stream"):
        assert metrics[m]["unit"] == "ms" and math.isfinite(metrics[m]["value"]) and metrics[m]["value"] > 0
    assert "update_device_ms.stream" not in metrics


def test_readers_and_a_wrapped_ring(tiny_cell, spans_ring):
    cell = _every_frame_a_keyframe(tiny_cell("kitti_stream"))
    run = spec.runner(cell.traffic).run(cell, SEED, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert run.units >= 2
    got = {m: spec.reader(m)(run) for m in HOST + DEVICE}
    for m in HOST:
        assert got[m] is not None and math.isfinite(got[m]) and got[m] > 0, m
    assert all(got[m] is None for m in DEVICE)
    # the window's frames: the roots of calls warm_frames .. warm_frames + units - 1
    frames = [s for s in spans_ring.spans() if s.name == "atdn::slam.frame"]
    warm = cell.traffic["warm_frames"]
    assert [s.request for s in frames[warm:warm + run.units]] == list(range(warm, warm + run.units))
    # each root lies inside the runner's timing of its call
    assert all(s.ms <= 1e3 * t for s, t in zip(frames[warm:warm + run.units], run.unit_s))

    # a wrap of the ring that drops the window's first frame, and nothing after it
    records = spans_ring.spans()
    first = records.index(frames[warm])
    for i in range(spans_ring.RING_SIZE - len(records) + first + 1):
        with spans_ring.span("filler", i):
            pass
    left = spans_ring.spans()
    assert frames[warm] not in left and frames[warm + 1] in left
    assert all(spec.reader(m)(run) is None for m in HOST)
