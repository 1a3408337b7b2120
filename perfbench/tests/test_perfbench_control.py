"""The check has to fail what is wrong.

The control: the reference one step below the precision the
configuration states (fp8 for the bf16 flow net, TF32 for the float32
ATDNVO), put in the program's place, fails the cell's limits. Each fault
that a cell can have, planted in the program underneath a run driven
through the harness, turns ``correct`` false: a step that returns its
state unchanged, half of the batch left out with the mean taken over
the rest, an answer altered where it is produced: in the stream cells
a carry, a pose, and a flow net that runs one update in place of the
configuration's or looks its correlation windows up at floored
coordinates. (One chip: no exchange between chips to leave out.)
"""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import control
from perfbench import run as harness
from perfbench.core.result import verdict


@pytest.mark.parametrize("name", ["kitti_stream", "cityscapes_stream", "kitti_odometry_train", "kitti_flow_train"])
def test_the_control_fails(tiny_cell, capsys, name):
    cell = tiny_cell(name)
    assert control.main(["--workload", name, "--control-seeds", str(2**31 + 99), "--seconds", "0.3"],
                        device="cpu", cell=cell) == 0
    reading = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert reading["as"] == "precision"
    assert not verdict(reading, cell.limits)[0]


def _run(cell, name, capsys) -> dict:
    assert harness.main(["--workload", name, "--seed", str(2**31 + 5), "--seconds", "0.3"], device="cpu",
                        cell=cell) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_stream_carry_left_unchanged_fails(tiny_cell, capsys, monkeypatch):
    from atdn_vslam_torch.models.odometry import ATDNVO

    forward = ATDNVO.forward
    monkeypatch.setattr(ATDNVO, "forward", lambda self, flows, carry: (forward(self, flows, carry)[0], carry))
    assert _run(tiny_cell("kitti_stream"), "kitti_stream", capsys)["correct"] is False


def test_stream_pose_altered_fails(tiny_cell, capsys, monkeypatch):
    from atdn_vslam_torch.slam import runtime

    to_matrix = runtime.pose_to_matrix

    def shifted(rot, tr):
        return to_matrix(rot, tr + torch.tensor([0.0, 0.0, 1e-2], device=tr.device))

    monkeypatch.setattr(runtime, "pose_to_matrix", shifted)
    assert _run(tiny_cell("kitti_stream"), "kitti_stream", capsys)["correct"] is False


def test_stream_one_update_fails(tiny_cell, capsys, monkeypatch):
    from atdn_vslam_torch.models.flow.network import RAFTGMA

    forward = RAFTGMA._forward

    def one_update(self, *args, **kwargs):
        iters, self.iters = self.iters, 1
        try:
            return forward(self, *args, **kwargs)
        finally:
            self.iters = iters

    monkeypatch.setattr(RAFTGMA, "_forward", one_update)
    result = _run(tiny_cell("kitti_stream"), "kitti_stream", capsys)
    assert result["correct"] is False
    assert [row["value"] for row in result["checks"] if row["name"] == "update_units"] == [float("inf")]


def test_stream_lookup_at_floored_coordinates_fails(tiny_cell, capsys, monkeypatch):
    from atdn_vslam_torch.models.flow import network

    lookup = network.lookup_corr_pyramid
    monkeypatch.setattr(network, "lookup_corr_pyramid",
                        lambda pyramid, coords, radius: lookup(pyramid, torch.floor(coords), radius))
    result = _run(tiny_cell("kitti_stream"), "kitti_stream", capsys)
    assert result["correct"] is False
    assert [row["value"] > row["limit"] for row in result["checks"] if row["name"] == "update_units"] == [True]


def test_stream_frame_the_hooks_miss_stops_the_run(tiny_cell, capsys, monkeypatch):
    # a CUDA graph replays without the forward hooks: the check would see nothing
    from perfbench.runners import stream

    monkeypatch.setattr(stream.Capture, "_odo", lambda self, module, args, out: None)
    with pytest.raises(RuntimeError, match="never fired"):
        harness.main(["--workload", "kitti_stream", "--seed", "3", "--seconds", "0.3"], device="cpu",
                     cell=tiny_cell("kitti_stream"))
    assert '"correct"' not in capsys.readouterr().out


@pytest.mark.parametrize("name,module", [("kitti_odometry_train", "odometry"), ("kitti_flow_train", "flow")])
def test_training_state_left_unchanged_fails(tiny_cell, capsys, monkeypatch, name, module):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert _run(tiny_cell(name), name, capsys)["correct"] is False


@pytest.mark.parametrize("name,module", [("kitti_odometry_train", "odometry"), ("kitti_flow_train", "flow")])
def test_training_on_half_the_batch_fails(tiny_cell, capsys, monkeypatch, name, module):
    import importlib

    program = importlib.import_module(f"atdn_vslam_torch.training.{module}")
    step = program.train_step

    def half(state, *batch, **kwargs):
        tensors = [x[: x.shape[0] // 2] if isinstance(x, torch.Tensor) else x for x in batch]
        return step(state, *tensors, **kwargs)

    monkeypatch.setattr(program, "train_step", half)
    assert _run(tiny_cell(name), name, capsys)["correct"] is False
