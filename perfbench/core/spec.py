"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout
and the files it names under ``perfbench/``.

A cell (an entry of ``workloads``) names its configuration, whose file
holds the model's sizes, and its traffic mix, ``traffic/<mix>.json``,
whose ``runner`` names the general runner that runs it
(``perfbench/runners/<runner>.py``). The limits of the cell's
correctness check are ``limits/<cell>.json`` (``limits``, with the
readings each was set from under ``set_from``). Every metric is read by
``metrics/<metric name>.py``, whose ``read(run)`` returns the number or
None. New cells, mixes and metrics are new files and entries; nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = _load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(ROOT / config["file"]),
        traffic=_load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(BENCH / "limits" / f"{name}.json")["limits"],
        end_to_end=end_to_end,
        per_layer=[m for m in spec["per_layer"] if _applies(m, name, reported)],
    )


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py`` (the file name is the metric's
    name, dots and all)."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def runner(traffic: dict):
    return importlib.import_module(f"perfbench.runners.{traffic['runner']}")
