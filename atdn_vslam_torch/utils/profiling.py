"""Profiling and tracing helpers, the port's counterpart of
``atdn_vslam_tpu/utils/profiling.py`` on ``torch.profiler``:

  * ``trace(dir)``: a context manager around ``torch.profiler.profile``
    (CPU and, where there is one, CUDA activity) that writes a Chrome
    trace into ``dir`` (open in Perfetto or TensorBoard);
  * ``timed(tag)``: a wall-clock stage timer that fences on its result
    (CUDA launches return before the work ends);
  * ``annotate(name)``: ``record_function``, so host stages show up in
    a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.utils._pytree as pytree
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json`` (Chrome trace
    format); yields the ``torch.profiler.profile`` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with record_function(name):
        yield


class timed:
    """Stage timer: ``with timed("flow") as t: t.result = f(x)``; leaving
    the block waits for the devices of the CUDA tensors in ``t.result``
    (if set), then reads the clock into ``t.seconds``."""

    def __init__(self, tag: str = "", fence=None):
        self.tag = tag
        self.result = fence
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.result is not None:
            for dev in {x.device for x in pytree.tree_leaves(self.result) if isinstance(x, torch.Tensor)}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.seconds = time.perf_counter() - self._t0
        return False
