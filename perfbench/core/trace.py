"""Traced slices of a run, reduced to what the metrics read.

``device_slice`` runs ``units`` more frames or steps under
``torch.profiler`` recording the device's activity alone (no host
operations, no shapes), which slows the host little, and keeps its host
seconds and the union of the device's operations (``Device``).

``capture`` runs two slices of ``units`` more frames or steps each under
``torch.profiler``. The first is such a device slice (or one the caller
ran already); the second records the host's operations too, with their
input shapes and a ``record_function`` range named ``perfbench.<layer>``
around every call of each given module (forward hooks the benchmark
registers; the program is not edited). ``Trace`` keeps:

- ``wall_s``: the host clock over the first slice, ending in a
  synchronise;
- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) in the first slice;
- from the second slice, ``launch_calls``: CPU-side launch calls of the CUDA APIs
  (``LAUNCH_CALLS``; a graph launch counts one);
- ``ranges``: device seconds of the kernels launched inside each range;
- ``ops``: for each ``atdn::`` op, its calls and the device seconds of
  its kernels;
- ``device_ops``: device seconds by operation name, the largest first;
- ``idle_gaps``: seconds in which the device was idle, by the innermost
  host operation running at the middle of each gap, the largest first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
})


@dataclasses.dataclass
class Device:
    """A slice recorded for the device alone."""

    units: int
    #: host seconds over the slice, ending in a synchronise
    wall_s: float
    #: the union of the device's operations (kernels, copies, sets)
    busy_s: float


@dataclasses.dataclass
class Trace:
    units: int
    wall_s: float
    busy_s: float
    launch_calls: int
    ranges: dict[str, float]
    ops: dict[str, tuple[int, float]]
    device_ops: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]


@contextlib.contextmanager
def _ranges(modules: dict):
    from torch.profiler import record_function

    handles, open_ranges = [], {}

    def enter(name):
        def hook(module, args):
            rf = record_function(f"perfbench.{name}")
            rf.__enter__()
            open_ranges.setdefault(name, []).append(rf)
        return hook

    def leave(name):
        def hook(module, args, out):
            open_ranges[name].pop().__exit__(None, None, None)
        return hook

    for name, module in modules.items():
        handles.append(module.register_forward_pre_hook(enter(name)))
        handles.append(module.register_forward_hook(leave(name)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _annotation(e) -> bool:
    """A host range the profiler also draws on the device's timeline: no
    operation of the device."""
    return getattr(e, "is_user_annotation", False) or e.name.startswith(("perfbench.", "Optimizer."))


def _timed(prof, step, first: int, units: int, device: torch.device) -> float:
    with prof:
        t0 = time.perf_counter()
        for i in range(first, first + units):
            step(i)
        _sync(device)
        return time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_slice(step, units: int, device: torch.device) -> Device | None:
    """``step(i)`` for i < ``units`` under the profiler, recording the
    device alone; None on the CPU (the CPU tests), which has no device
    timeline."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    _sync(device)
    prof = profile(activities=[ProfilerActivity.CUDA])
    wall_s = _timed(prof, step, 0, units, device)
    return Device(units=units, wall_s=wall_s, busy_s=_busy_of(prof))


def capture(step, units: int, device: torch.device, modules: dict | None = None,
            device_part: Device | None = None) -> Trace:
    """``step(i)`` for i < 2 ``units`` under the profiler: the device's
    slice, then the host's (the CPU alone, and no device slice, when
    ``device`` is the CPU, in the CPU tests). With ``device_part`` (a
    device slice the caller ran already) only the host's slice runs, on
    i < ``units``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    first = 0
    if device_part is None and cuda:
        device_part = device_slice(step, units, device)
        first = units
    _sync(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _ranges(modules or {}):
        prof = profile(activities=activities, record_shapes=True)
        host_wall_s = _timed(prof, step, first, units, device)
    trace = reduce(prof.events(), units, host_wall_s)
    if device_part is None:
        return trace
    return dataclasses.replace(trace, busy_s=device_part.busy_s, wall_s=device_part.wall_s)


def _busy_of(prof) -> float:
    """The union of the device's operations in a profile, in seconds,
    from the profiler's raw events (thousands a frame), without
    the event list the host's slice builds."""
    spans = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
             and not e.name().startswith(("perfbench.", "Optimizer."))]
    return _union(spans)[0] * 1e-9


def _device_events(events) -> list:
    return [e for e in events if _device(e) and not _annotation(e)]


def _busy(device) -> tuple[float, list[tuple[int, int]]]:
    """The union of the device events' spans in seconds, and the gaps
    between them (profiler microseconds)."""
    busy, gaps = _union([(e.time_range.start, e.time_range.end) for e in device])
    return busy * 1e-6, gaps


def _union(spans) -> tuple[float, list[tuple[int, int]]]:
    """The length of the union of ``(start, end)`` spans, and the gaps
    between them, in the spans' unit."""
    busy, gaps, cur = 0.0, [], None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], start))
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def reduce(events, units: int, wall_s: float) -> Trace:
    device = _device_events(events)
    host = [e for e in events if not _device(e)]
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    busy, gaps = _busy(device)

    ranges: dict[str, float] = defaultdict(float)
    ops: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in host:
        if e.name.startswith("perfbench."):
            ranges[e.name[len("perfbench."):]] += e.device_time_total * 1e-6
        elif e.name.startswith("atdn::"):
            ops[e.name][0] += 1
            ops[e.name][1] += e.device_time_total * 1e-6
    return Trace(
        units=units, wall_s=wall_s, busy_s=busy,
        launch_calls=sum(e.name in LAUNCH_CALLS for e in host),
        ranges=dict(ranges), ops={k: (v[0], v[1]) for k, v in ops.items()},
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_gaps=_name_gaps(host, gaps),
    )


def _name_gaps(host, gaps, top: int = 400) -> list[tuple[str, float]]:
    """Idle seconds by the innermost host operation (not a CUDA API call)
    open at the middle of each of the ``top`` longest gaps."""
    ops = [e for e in host if not e.name.startswith(("cuda", "cu"))]
    if not gaps or not ops:
        return []
    starts = np.array([e.time_range.start for e in ops], dtype=np.float64)
    ends = np.array([e.time_range.end for e in ops], dtype=np.float64)
    total: dict[str, float] = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = ops[int(inside[np.argmax(starts[inside])])].name if len(inside) else "(between host operations)"
        total[name] += (g1 - g0) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])


def breakdown(trace: Trace, top: int = 10) -> dict:
    return {
        "device_ops": [[name[:120], s] for name, s in trace.device_ops[:top]],
        "idle_gaps": [[name[:120], s] for name, s in trace.idle_gaps[:top]],
    }
