"""What one run of a cell gives the metric readers and the check."""

from __future__ import annotations

import dataclasses

from perfbench.core.spec import Cell
from perfbench.core.trace import Device, Trace


@dataclasses.dataclass
class Run:
    cell: Cell
    setup_s: float
    #: frames or steps completed in the measured window, and the samples
    #: they hold (a frame, a window of flows or an image pair each)
    units: int
    samples: int
    window_s: float
    #: host seconds of each unit of the window
    unit_s: list[float]
    memory_peak_bytes: int
    #: the numbers the check compares, by name
    checks: dict[str, float] = dataclasses.field(default_factory=dict)
    #: a slice after the window recorded for the device alone (every run
    #: of a cell whose mix asks for one), the traced slice (``--trace 1``)
    #: and the operations of one unit by type
    device_slice: Device | None = None
    trace: Trace | None = None
    flops: dict[str, float] | None = None
    extra: dict = dataclasses.field(default_factory=dict)


def verdict(checks: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[dict]]:
    """Each number against its limit (a number passes at or under it; a
    missing or non-finite number fails), in the limits' order."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = checks.get(name)
        passed = value is not None and value == value and value <= limit
        ok &= passed
        rows.append({"name": name, "value": value, "limit": limit})
    return ok, rows
