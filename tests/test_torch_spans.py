"""The port's spans (``atdn_vslam_torch/utils/profiling.py``) on the CPU:
nesting, parents and request ids, threads, the bounded ring, the
``record_function`` range that only a recording profiler gets, nothing
recorded under ``torch.export`` or ``torch.compile``; the spans of a
streaming ``SlamRuntime`` frame, of a closure measurement and of the
keyframe store's writer; the benchmark's trace reduction counting them;
and the serving export holding no profiler op.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atdn_vslam_torch import serving
from atdn_vslam_torch.config import Config, FlowNetConfig, SlamConfig
from atdn_vslam_torch.models.factory import build_flow_model, build_odometry_model
from atdn_vslam_torch.slam import SlamRuntime
from atdn_vslam_torch.slam.keyframes import KeyframeStore
from atdn_vslam_torch.utils import profiling
from atdn_vslam_torch.utils.profiling import span

H, W = 96, 192
ITERS = 2
FRAME_CHILDREN = ["atdn::slam.prepare", "atdn::slam.flow", "atdn::slam.odometry", "atdn::slam.pose_wait",
                  "atdn::slam.keyframe"]


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear()
    yield
    profiling.clear()


def _children(records):
    kids = {}
    for s in records:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _names(records):
    return [s.name for s in records]


def test_spans_nest_with_parents_and_requests():
    with span("root", 7):
        with span("a"):
            with span("a.inner", 8):
                with span("a.inner.leaf"):
                    pass
        with span("b"):
            pass
    with span("other"):
        pass
    got = profiling.spans()
    assert _names(got) == ["root", "a", "a.inner", "a.inner.leaf", "b", "other"]
    root, a, inner, leaf, b, other = got
    assert [s.index for s in got] == sorted(s.index for s in got)
    assert len({s.index for s in got}) == 6
    assert root.parent is None and other.parent is None
    assert a.parent == root.index and b.parent == root.index
    assert inner.parent == a.index and leaf.parent == inner.index
    # a span opened without an id takes its enclosing span's
    assert (root.request, a.request, inner.request, leaf.request, b.request) == (7, 7, 8, 8, 7)
    assert other.request is None
    assert all(s.start_ns <= s.end_ns for s in got)
    assert root.start_ns <= a.start_ns and a.end_ns <= b.start_ns and b.end_ns <= root.end_ns
    assert {s.thread for s in got} == {threading.get_ident()}


def test_open_span_and_current_request():
    assert profiling.current_request() is None
    with span("outer", "r1"):
        with span("inner"):
            (outer, inner) = profiling.spans()
            assert outer.end_ns is None and inner.end_ns is None
            assert profiling.current_request() == "r1"
    assert profiling.current_request() is None
    assert all(s.end_ns is not None and s.ms >= 0 for s in profiling.spans())


def test_a_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with span("root", 1):
            with span("fails"):
                raise ValueError("boom")
    with span("after"):
        pass
    root, fails, after = profiling.spans()
    assert fails.end_ns is not None and root.end_ns is not None
    assert after.parent is None and after.request is None


def test_threads_are_kept_apart():
    """Threads open spans at once under a short switch interval: each
    thread's spans nest among themselves, never under another's."""
    n_threads, per_thread = 12, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per_thread):
                with span("t.root", (k, i)):
                    with span("t.child"):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) == 2 * n_threads * per_thread
    assert len({s.index for s in got}) == len(got)
    by_index = {s.index: s for s in got}
    roots = [s for s in got if s.name == "t.root"]
    assert all(s.parent is None for s in roots)
    # one thread each (a finished thread's ident may be given to a later one)
    assert all(len({s.thread for s in roots if s.request[0] == k}) == 1 for k in range(n_threads))
    assert sorted(s.request for s in roots) == sorted((k, i) for k in range(n_threads) for i in range(per_thread))
    for child in (s for s in got if s.name == "t.child"):
        parent = by_index[child.parent]
        assert parent.name == "t.root" and parent.thread == child.thread and parent.request == child.request


def test_the_ring_is_bounded():
    extra = 5
    for i in range(profiling.RING_SIZE + extra):
        with span("x", i):
            pass
    got = profiling.spans()
    assert len(got) == profiling.RING_SIZE
    assert got[0].request == extra and got[-1].request == profiling.RING_SIZE + extra - 1


def test_record_function_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = profiling.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    with span("atdn::test.off"):
        torch.ones(8).sum()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("atdn::test.on", 3):
            with span("atdn::test.inner"):
                torch.ones(8).sum()
    assert opened == ["atdn::test.on", "atdn::test.inner"]
    names = [e.name for e in prof.events()]
    assert names.count("atdn::test.on") == 1 and names.count("atdn::test.inner") == 1
    assert _names(profiling.spans()) == ["atdn::test.off", "atdn::test.on", "atdn::test.inner"]


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with span("atdn::test.traced"):
            return x.sin() + 1


def test_nothing_recorded_while_compiling():
    x = torch.linspace(0, 1, 5)
    exported = torch.export.export(_Spanned(), (x,))
    assert not any("profiler" in str(n.target) or "record_function" in str(n.target)
                   for n in exported.graph.nodes)
    compiled = torch.compile(_Spanned(), backend="eager", fullgraph=True)
    with profile(activities=[ProfilerActivity.CPU]):
        torch.testing.assert_close(compiled(x), x.sin() + 1)
    assert profiling.spans() == []
    _Spanned()(x)
    assert _names(profiling.spans()) == ["atdn::test.traced"]


def test_keyframe_store_spans_stall_and_write(tmp_path, monkeypatch):
    """A queue of one write: the second and third appends wait on the
    writer (``stall``); each write runs on the writer thread under the
    request of the frame that appended it."""
    real_save = np.save

    def slow_save(*args, **kwargs):
        time.sleep(0.05)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(np, "save", slow_save)
    store = KeyframeStore(str(tmp_path / "kf"), async_writes=True, max_pending=1)
    store.initialize_cold()
    rgb = np.zeros((8, 8, 3), np.uint8)
    for frame in range(3):
        with span("atdn::slam.frame", frame):
            store.append(rgb, np.eye(4))
    store.flush()
    got = profiling.spans()
    by_index = {s.index: s for s in got}
    appends = [s for s in got if s.name == "atdn::keyframes.append"]
    stalls = [s for s in got if s.name == "atdn::keyframes.stall"]
    writes = sorted((s for s in got if s.name == "atdn::keyframes.write"), key=lambda s: s.request)
    assert [s.request for s in appends] == [0, 1, 2]
    assert [s.request for s in stalls] == [1, 2]
    assert all(by_index[s.parent].name == "atdn::keyframes.append" for s in stalls)
    assert [s.request for s in writes] == [0, 1, 2]
    assert all(s.parent is None and s.thread != threading.get_ident() for s in writes)
    # the queue's depth from the record: each stall ends once an earlier write has
    assert all(any(w.end_ns <= s.end_ns for w in writes) for s in stalls)
    assert len(store) == 3 and store.read_rgb(2).shape == (8, 8, 3)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False), slam=SlamConfig(image_height=H, image_width=W))
    return (build_flow_model(cfg, "cpu").state_dict(), build_odometry_model(cfg, "cpu").state_dict())


def _runtime(tmp_path, weights):
    # thresholds of 0 register every frame as a keyframe
    cfg = Config(
        keyframes_path=str(tmp_path / "kf"),
        flow=FlowNetConfig(iters=ITERS, mixed_precision=False),
        slam=SlamConfig(image_height=H, image_width=W, rotation_threshold_deg=0.0, translation_threshold=0.0),
    )
    rt = SlamRuntime(cfg, *weights, device="cpu")
    rt.start_odometry()
    return rt


def _frames(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(n)]


def test_runtime_frame_spans(tmp_path, weights):
    rt = _runtime(tmp_path, weights)
    n = 4
    for frame in _frames(n):
        rt(frame)
    rt.keyframes.flush()
    got = profiling.spans()
    kids = _children(got)
    main = threading.get_ident()
    frames = [s for s in got if s.name == "atdn::slam.frame"]
    # one root a call, its request the call index
    assert [s.request for s in frames] == list(range(n))
    assert all(s.parent is None and s.thread == main for s in frames)
    first, rest = frames[0], frames[1:]
    assert _names(kids[first.index]) == ["atdn::slam.prepare", "atdn::slam.flow", "atdn::slam.keyframe"]
    assert _names(kids[kids[first.index][1].index]) == ["atdn::flow.encode"]
    for f in rest:
        children = kids[f.index]
        assert _names(children) == FRAME_CHILDREN
        assert all(c.request == f.request for c in children)
        assert all(f.start_ns <= c.start_ns <= c.end_ns <= f.end_ns for c in children)
        flow = kids[children[1].index]
        assert _names(flow) == ["atdn::flow.encode"] + ["atdn::flow.update"] * ITERS + ["atdn::flow.upsample"]
        assert all(s.request == f.request for s in flow)
        assert _names(kids[children[2].index]) == ["atdn::slam.pose_matrix"]
        assert _names(kids[children[4].index]) == ["atdn::keyframes.append"]
    # every frame registered a keyframe: one write each, on the writer thread
    writes = [s for s in got if s.name == "atdn::keyframes.write"]
    assert sorted(s.request for s in writes) == list(range(n))
    assert all(s.parent is None and s.thread != main for s in writes)

    profiling.clear()
    rt.measure_closure(0, 2)
    got = profiling.spans()
    kids = _children(got)
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "atdn::slam.closure" and root.request == (0, 2)
    assert _names(kids[root.index]) == ["atdn::slam.flow", "atdn::slam.flow", "atdn::slam.odometry"]
    assert _names(kids[kids[root.index][2].index]) == ["atdn::slam.pose_matrix"]
    assert all(s.request == (0, 2) for s in got)


def test_trace_reduction_counts_the_spans(tmp_path, weights):
    """Under a CPU profile the benchmark's reduction keeps every
    ``atdn::`` span with its calls (``perfbench/core/trace.py``)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.core import trace as tracing

    rt = _runtime(tmp_path, weights)
    frames = _frames(4)
    rt(frames[0])
    units = 3
    got = tracing.capture(lambda k: rt(frames[1 + k]), units, torch.device("cpu"))
    rt.keyframes.flush()
    calls = {name: got.ops.get(name, (0, 0.0))[0] for name in (
        "atdn::slam.frame", *FRAME_CHILDREN, "atdn::slam.pose_matrix", "atdn::flow.encode", "atdn::flow.update",
        "atdn::flow.upsample", "atdn::keyframes.append")}
    assert calls == {"atdn::slam.frame": units, **dict.fromkeys(FRAME_CHILDREN, units),
                     "atdn::slam.pose_matrix": units, "atdn::flow.encode": units, "atdn::flow.update": units * ITERS,
                     "atdn::flow.upsample": units, "atdn::keyframes.append": units}
    assert not any(name.startswith("atdn::") and "." in name for name, _ in got.device_ops)


def test_serving_export_holds_no_profiler_op(weights):
    cfg = Config(flow=FlowNetConfig(iters=ITERS, mixed_precision=False), slam=SlamConfig(image_height=H, image_width=W))
    flow, odo = build_flow_model(cfg, "cpu"), build_odometry_model(cfg, "cpu")
    flow.load_state_dict(weights[0])
    odo.load_state_dict(weights[1])
    exported = serving.export_stream_step(flow, odo, None, None, H, W)
    targets = [str(n.target) for n in exported.graph.nodes]
    assert not any("profiler" in t or "record_function" in t for t in targets)
    # the eager encoding of the example frame records; the traced step does not
    assert "atdn::flow.update" not in _names(profiling.spans())
