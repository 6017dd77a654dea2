"""The port's recorder (``utils.profiling``): spans only while tracing,
their parents and self time, counters, the profiler's clock, the spans in
``trace_run``'s Chrome trace, the fast path's spans, and the union of
device records in ``experiments.device_time_probe`` (CPU)."""

import contextlib
import glob
import json
import math
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sspslam_tpu_torch import FastPathIntegrator, HexagonalSSPSpace
from sspslam_tpu_torch.experiments import device_time_probe
from sspslam_tpu_torch.models import fast_pathint
from sspslam_tpu_torch.utils import profiling
from sspslam_tpu_torch.utils.profiling import span

#: how far an op's profiler record may lie outside the span around it
CLOCK_TOL_NS = 50_000


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    assert not profiling.tracing_on()
    assert span("a") is span("b")
    monkeypatch.setattr(profiling.time, "perf_counter_ns", None)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("pi.run"):
                with span("pi.upload"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__
             and d.size_diff > 0]
    assert grown == []
    assert profiling.spans() == []


def test_on_inside_a_profile_and_tracing():
    assert not profiling.tracing_on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing_on()
        with span("in_profile"):
            pass
    assert not profiling.tracing_on()
    with profiling.tracing():
        with profiling.tracing():
            assert profiling.tracing_on()
        assert profiling.tracing_on()
        with span("in_tracing"):
            pass
    assert not profiling.tracing_on()
    with span("off"):
        pass
    assert [s.name for s in profiling.spans()] == ["in_profile",
                                                   "in_tracing"]


def test_nesting_parents_and_self_time():
    with profiling.tracing():
        with span("a"):
            with span("b"):
                time.sleep(0.002)
            with span("c"):
                with span("d"):
                    time.sleep(0.001)
        with span("e"):
            pass
    recs = profiling.spans()
    assert [(s.name, s.parent) for s in recs] == [
        ("a", -1), ("b", 0), ("c", 0), ("d", 2), ("e", -1)]
    assert all(0 < s.start_ns < s.end_ns for s in recs)
    a, b, c, d, _ = recs
    assert a.start_ns <= b.start_ns and b.end_ns <= c.start_ns
    assert c.start_ns <= d.start_ns and d.end_ns <= c.end_ns <= a.end_ns
    dur = [s.end_ns - s.start_ns for s in recs]
    assert profiling.self_ns(recs, 0) == dur[0] - dur[1] - dur[2]
    assert profiling.self_ns(recs, 2) == dur[2] - dur[3]
    assert profiling.self_ns(recs, 3) == dur[3]
    profiling.reset()
    assert profiling.spans() == []


def test_counters():
    assert profiling.counter("x") == 0
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 2)
    assert (profiling.counter("x"), profiling.counter("y")) == (5, 2)
    profiling.reset()
    assert profiling.counter("x") == 0


def test_spans_on_the_profilers_clock():
    a = torch.ones(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("mm"):
                a @ a
    offset = profiling.profiler_clock_offset_ns()
    recs = profiling.spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(recs) == len(ops) == 3
    for s, e in zip(recs, ops):
        assert s.start_ns + offset - CLOCK_TOL_NS <= e.start_ns()
        assert e.end_ns() <= s.end_ns + offset + CLOCK_TOL_NS


def test_trace_run_holds_the_spans(tmp_path):
    a = torch.ones(192, 192)
    with profiling.tracing():
        with span("before"):
            pass
    with profiling.trace_run(str(tmp_path)):
        with span("outer"):
            with span("mm"):
                a @ a
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    mine = {e["name"]: e for e in events
            if e.get("pid") == profiling.SPAN_ROW and e["ph"] == "X"}
    assert set(mine) == {"outer", "mm"}
    assert mine["mm"]["args"]["parent"] == "outer"
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    tol = CLOCK_TOL_NS / 1e3
    assert mine["mm"]["ts"] - tol <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= mine["mm"]["ts"] + mine["mm"]["dur"] + tol
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.SPAN_ROW
               for e in events)


@pytest.fixture(scope="module")
def fpi():
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                              domain_bounds=bounds)
    return FastPathIntegrator(space, 24, seed=0, chunk_steps=100,
                              device="cpu")


@pytest.mark.parametrize("corrections", [False, True])
def test_fast_path_spans(fpi, corrections):
    T = 250
    vels = (0.05 * np.random.default_rng(1).normal(size=(T, 2))).astype(
        np.float32)
    corr = np.zeros((T, fpi.d), np.float32) if corrections else None
    with profiling.tracing():
        fpi.state = fpi.initial_state()
        out = fpi.run(vels, corr)
    assert out.shape == (T, fpi.d)
    recs = profiling.spans()
    names = [(s.name, recs[s.parent].name if s.parent >= 0 else None)
             for s in recs]
    calls = math.ceil(T / fpi.chunk_steps)
    assert names == [("pi.initial_state", None), ("pi.run", None),
                     ("pi.upload", "pi.run")] \
        + [("vco_scan.call", "pi.run")] * calls \
        + [("pi.wait", "pi.run"), ("pi.download", "pi.run")]
    run = recs[1]
    for s in recs[2:]:
        assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    assert profiling.counter("vco_scan.launches") == 0


class _FakeCuda:
    """``fast_pathint``'s torch with a CUDA device that puts tensors on
    the CPU and records each wait the run asks for."""

    def __init__(self):
        self.waits = []
        stream = types.SimpleNamespace(
            synchronize=lambda: self.waits.append("stream"))
        self.cuda = types.SimpleNamespace(
            synchronize=lambda device=None: self.waits.append("device"),
            current_stream=lambda device=None: stream)
        self.float32, self.cat = torch.float32, torch.cat

    def as_tensor(self, x, dtype=None, device=None):
        return torch.as_tensor(x, dtype=dtype)

    def zeros(self, shape, dtype=None, device=None):
        return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("traced, transfer, waits", [
    (False, True, []),            # the copy to the host waits
    (True, True, ["stream"]),     # pi.wait, then the copy
    (False, False, ["device"]),
    (True, False, ["device"]),
])
def test_fast_path_waits_only_while_tracing(fpi, monkeypatch, traced,
                                            transfer, waits):
    fake = _FakeCuda()
    monkeypatch.setattr(fast_pathint, "torch", fake)
    monkeypatch.setattr(fpi, "device", torch.device("cuda"))
    vels = np.zeros((150, 2), np.float32)
    fpi.state = fast_pathint.initial_vco_state(fpi.n, fpi.k, device="cpu")
    with profiling.tracing() if traced else contextlib.nullcontext():
        fpi.run(vels, transfer=transfer)
    assert fake.waits == waits


def test_device_busy_is_the_union_of_records():
    recs = [(100, 200), (150, 250), (240, 260), (400, 450), (900, 1200)]
    assert device_time_probe.merge(recs) == [[100, 260], [400, 450],
                                             [900, 1200]]
    # the sum of durations would be 100 + 100 + 20 + 50 + 300 = 570
    assert device_time_probe.busy_ns(recs, 0, 1000) == 160 + 50 + 100
    assert device_time_probe.busy_ns(recs, 120, 420) == 140 + 20
    assert device_time_probe.busy_ns([], 0, 10) == 0
