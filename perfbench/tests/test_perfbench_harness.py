"""A tiny run of each cell's runner through the harness on the CPU: the
contract's last line, and ``correct`` true on the program as it is."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import run as harness
from perfbench.core import spec

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,trace", [
    ("kitti_stream", 0), ("kitti_stream", 1), ("kitti_odometry_train", 0), ("kitti_odometry_train", 1),
    ("kitti_flow_train", 0),
])
def test_tiny_run_prints_the_result_line(tiny_cell, capsys, name, trace):
    cell = tiny_cell(name)
    rc = harness.main(["--workload", name, "--seed", str(2**31 + 12345), "--seconds", "0.5",
                       "--trace", str(trace)], device="cpu", cell=cell)
    assert rc == 0
    result = _last_line(capsys)
    assert RESULT_KEYS <= set(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert [row["name"] for row in result["checks"]] == list(cell.limits)
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        # the CPU has no device timeline to read a device metric from
        host = {m["name"] for m in cell.end_to_end if m["source"] != "device_trace"}
        assert host <= set(result["metrics"])
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        assert "breakdown" in result and {"busy_s", "window_s"} <= set(result["device"])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    rc = harness.main(["--workload", "kitti_stream", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_every_cell_finds_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert spec.runner(cell.traffic).run
        assert cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_same_seed_same_inputs():
    from perfbench.runners.stream import synthetic_frames, seeded_weights

    cfg = spec.load_cell("kitti_stream").config
    a, b = (synthetic_frames(3, (64, 96), 2**31 + 7) for _ in range(2))
    assert all((x == y).all() for x, y in zip(a, b))
    wa, wb = (seeded_weights(cfg, 2**31 + 7, torch.device("cpu")) for _ in range(2))
    assert all(torch.equal(wa[i][k], wb[i][k]) for i in range(2) for k in wa[i])
