"""The GMFlow stream cell (``gmflow_kitti_stream``) shrunk through the
harness on the CPU: the contract's last line and ``correct`` true on the
program as it is; the control and each planted fault fail (the shifted
windows' mask dropped, a block skipped, the propagation skipped, the
matching's features rounded to bf16, a stale carry); the reference loads
nothing of the program. And the data-parallel training runner with two
gloo ranks on the CPU."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from perfbench import control
from perfbench import run as harness
from perfbench.core import spec
from perfbench.core.result import verdict

NAME = "gmflow_kitti_stream"
#: frames whose 16x24 tokens split into 2x2 windows of 8x12, shifted by (4, 6)
TINY_HW = (128, 192)
SEED = 2**31 + 12345


def _tiny() -> spec.Cell:
    cell = spec.load_cell(NAME)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image_height=TINY_HW[0], image_width=TINY_HW[1])
    traffic = {**cell.traffic, "pool_frames": 6, "profile_frames": 2, "check_samples": 2}
    return spec.Cell(cell.name, cell.chips, cfg, traffic, dict(cell.limits), cell.end_to_end, cell.per_layer)


def _run(capsys, trace: int = 0) -> dict:
    assert harness.main(["--workload", NAME, "--seed", str(SEED), "--seconds", "0.3", "--trace", str(trace)],
                        device="cpu", cell=_tiny()) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _failed(result: dict) -> set[str]:
    return {row["name"] for row in result["checks"] if not row["value"] <= row["limit"]}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_result_line(capsys, trace):
    result = _run(capsys, trace)
    cell = _tiny()
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert [row["name"] for row in result["checks"]] == list(cell.limits)
    assert set(result["metrics"]) <= {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert "setup_s" in result["metrics"] or trace


def test_the_control_fails(capsys):
    cell = _tiny()
    assert control.main(["--workload", NAME, "--control-seeds", str(2**31 + 99), "--seconds", "0.3"],
                        device="cpu", cell=cell) == 0
    reading = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert reading["as"] == "precision"
    assert not verdict(reading, cell.limits)[0]


def test_shift_mask_dropped_fails(capsys, monkeypatch):
    from atdn_vslam_torch.models.flow import gmflow

    monkeypatch.setattr(gmflow, "flash_attend_regions", lambda q, k, v, regions, scale: gmflow.flash_attend(q, k, v, scale))
    result = _run(capsys)
    assert result["correct"] is False and "transformer_units" in _failed(result)


def test_a_block_skipped_fails(capsys, monkeypatch):
    from atdn_vslam_torch.models.flow.gmflow import FeatureTransformer

    forward = FeatureTransformer.forward

    def five_blocks(self, feature0, feature1, splits):
        layers, self.layers = self.layers, self.layers[:-1]
        try:
            return forward(self, feature0, feature1, splits)
        finally:
            self.layers = layers

    monkeypatch.setattr(FeatureTransformer, "forward", five_blocks)
    result = _run(capsys)
    assert result["correct"] is False and "transformer_units" in _failed(result)


def test_propagation_skipped_fails(capsys, monkeypatch):
    from atdn_vslam_torch.models.flow.gmflow import FeatureFlowAttention

    monkeypatch.setattr(FeatureFlowAttention, "forward", lambda self, feature0, flow: flow)
    result = _run(capsys)
    assert result["correct"] is False and "propagate_rel" in _failed(result)


@pytest.mark.parametrize("kind", ["tf32", "bf16"])
def test_matching_in_a_narrower_type_fails(capsys, monkeypatch, kind):
    from atdn_vslam_torch.models.flow.gmflow import GlobalMatching
    from perfbench.reference.precision import Precision

    forward, narrow = GlobalMatching.forward, Precision(kind).operand
    monkeypatch.setattr(GlobalMatching, "forward", lambda self, f0, f1: forward(self, narrow(f0), narrow(f1)))
    result = _run(capsys)
    assert result["correct"] is False and "match_rel" in _failed(result)


def test_stale_carry_fails(capsys, monkeypatch):
    from atdn_vslam_torch.models.odometry import ATDNVO

    forward = ATDNVO.forward
    monkeypatch.setattr(ATDNVO, "forward", lambda self, flows, carry: (forward(self, flows, carry)[0], carry))
    result = _run(capsys)
    assert result["correct"] is False and {"odometry_rel", "carry_chain"} & _failed(result)


def test_the_gmflow_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, json, perfbench.reference.gmflow\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "atdn_vslam_tpu", "atdn_vslam_torch"}


@pytest.mark.parametrize("key,value", [("feature_channels", 96), ("num_transformer_layers", 4), ("attn_splits", 1)])
def test_a_configuration_off_the_published_widths_is_refused(key, value):
    from perfbench.runners import gmflow_stream

    cfg = copy.deepcopy(spec.load_cell(NAME).config)
    gmflow_stream.port_config(cfg, "unused")
    cfg["flow"][key] = value
    with pytest.raises(ValueError, match=key):
        gmflow_stream.port_config(cfg, "unused")
