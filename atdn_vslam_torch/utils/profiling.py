"""Profiling and tracing of the port, on ``torch.profiler``:

  * ``span(name, request=None)``: a context manager that records where
    host time goes. Every span appends one record to a process-wide
    ring of ``RING_SIZE`` records (``spans()`` reads it): its name, the
    request it serves, the record of the span it opened inside, its
    thread, and its start and end on ``time.perf_counter_ns``. While a
    profiler is recording, the span also opens a ``record_function``
    range of its name, so it sits in the profile's timeline beside the
    device's kernels, and the profile counts the kernels launched inside
    it. A span never waits for the device and never reads a tensor.
    Under ``torch.compile`` or ``torch.export`` it records nothing and
    adds nothing to the graph;
  * ``spans()`` / ``clear()``: a snapshot of the ring, and emptying it;
  * ``trace(dir)``: a context manager around ``torch.profiler.profile``
    (CPU and, where there is one, CUDA activity) that writes a Chrome
    trace, spans included, into ``dir`` (open in Perfetto or
    TensorBoard).

The program's span names live in the ``atdn::`` namespace of its ops:
``atdn::slam.*`` in the runtime, ``atdn::flow.*`` in RAFTGMA,
``atdn::gmflow.*`` in GMFlow and ``atdn::keyframes.*`` in the keyframe
store.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import ProfilerActivity, profile, record_function

#: records the ring keeps; the oldest go first
RING_SIZE = 2**17


class Span(NamedTuple):
    """One record of the ring."""

    #: the order in which the spans were opened, process-wide
    index: int
    name: str
    #: the request the span serves: given, or its enclosing span's
    request: Any
    #: ``index`` of the enclosing span on the same thread (None at a root)
    parent: int | None
    #: ``threading.get_ident()`` of the thread that opened it
    thread: int
    start_ns: int
    #: None while the span is open
    end_ns: int | None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_indices = itertools.count()
_open = threading.local()
# bound once: a span is on the per-frame path
_now = time.perf_counter_ns
_thread = threading.get_ident
_is_compiling = torch.compiler.is_compiling


class span:
    """``with span("atdn::slam.flow"):`` records the block (module
    docstring). ``request`` names what the span serves (a frame's call
    index, say); None takes the request of the enclosing span on the
    same thread."""

    __slots__ = ("name", "request", "_record", "_range")

    def __init__(self, name: str, request: Any = None):
        self.name = name
        self.request = request

    def __enter__(self):
        if _is_compiling():
            self._record = None
            return self
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
        request = self.request
        if stack:
            outer = stack[-1]
            parent = outer[0]
            if request is None:
                request = outer[2]
        else:
            parent = None
        record = [next(_indices), self.name, request, parent, _thread(), 0, None]
        stack.append(record)
        _ring.append(record)
        self._record = record
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        record[5] = _now()
        return self

    def __exit__(self, *exc):
        record = self._record
        if record is None:
            return False
        record[6] = _now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open.stack.pop()
        return False


def current_request() -> Any:
    """The request of the innermost span open on this thread, or None;
    work handed to another thread carries it there."""
    stack = getattr(_open, "stack", None)
    return stack[-1][2] if stack else None


def spans() -> list[Span]:
    """The ring's records, oldest first (the order they were opened)."""
    return [Span(*r) for r in _ring.copy()]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


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
