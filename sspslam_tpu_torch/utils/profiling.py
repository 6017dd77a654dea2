"""A built model's resource summary (neurons, weight and state memory and
the multiply-adds of one step, per ensemble group), a trace context, and
the program's own spans and counters.

Port of :mod:`sspslam_tpu.utils.profiling`: ``model_utilization_summary``
and ``print_utilization_summary`` (the counterpart of the reference's
Loihi utilization printout; host-only arithmetic on the built shapes, with
no counterpart of the JAX module's TPU on-chip-memory share) and
``trace_run``, a ``torch.profiler`` context in place of the JAX module's
``jax.profiler`` one.

The recorder (no counterpart in the JAX package): :func:`span` marks a
stretch of host time where the program does its work (``with
span("pi.upload"): ...``), with the span open around it as its parent;
:func:`count` adds to a named counter, :func:`count_traced` only while
tracing is on.  Spans are recorded only while tracing is on, that is
while a ``torch.profiler`` profile records or inside :func:`tracing`;
otherwise :func:`span` hands back one shared object that reads no clock.
Counters are always kept.  Spans are kept in
memory (:func:`spans`) on the ``time.perf_counter_ns()`` clock, which
:func:`profiler_clock_offset_ns` maps onto the profiler's; no profiler
range is opened, so the device trace holds only the device's work.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

__all__ = ["model_utilization_summary", "print_utilization_summary",
           "trace_run", "Span", "span", "tracing", "tracing_on", "spans",
           "self_ns", "count", "count_traced", "counter", "reset",
           "profiler_clock_offset_ns"]


def _size(x) -> int:
    return int(x.numel()) if torch.is_tensor(x) else int(np.size(x))


def model_utilization_summary(model) -> List[dict]:
    """Per-ensemble-group resource rows for a built Model."""
    rows = []
    conn_by_pre = {}
    for bc in model.connections:
        if bc.decoders is not None:
            conn_by_pre.setdefault(id(bc.pre), []).append(bc)

    for be in model.ensembles:
        n_neurons = be.k * be.n if be.batched else be.n
        enc_elems = _size(be.scaled_encoders)
        dec_elems = sum(_size(bc.decoders)
                        for bc in conn_by_pre.get(id(be), []))
        # J matvec + decode matvecs, 2 flops per MAC
        flops = 2 * (enc_elems + dec_elems)
        state_bytes = sum(
            _size(v) * 4 for v in be.neuron_type.init_state(
                (be.k, be.n) if be.batched else (be.n,)).values())
        rows.append({
            "label": getattr(be.obj, "label", None) or f"ens{be.index}",
            "batched": be.batched,
            "neurons": int(n_neurons),
            "encoder_bytes": enc_elems * 4,
            "decoder_bytes": dec_elems * 4,
            "state_bytes": int(state_bytes),
            "flops_per_step": int(flops),
        })
    return rows


def print_utilization_summary(model, file=None):
    rows = model_utilization_summary(model)
    total_neurons = sum(r["neurons"] for r in rows)
    total_bytes = sum(r["encoder_bytes"] + r["decoder_bytes"]
                      + r["state_bytes"] for r in rows)
    total_flops = sum(r["flops_per_step"] for r in rows)
    print(f"model resources: {len(rows)} ensemble groups, "
          f"{total_neurons} neurons, "
          f"{total_bytes / 2**20:.1f} MiB weights+state, "
          f"~{total_flops / 1e6:.2f} MFLOP/step", file=file)
    for r in sorted(rows, key=lambda r: -r["flops_per_step"])[:8]:
        kib = (r["encoder_bytes"] + r["decoder_bytes"]) / 2**10
        print(f"  {r['label']:<24} {r['neurons']:>7} neurons  "
              f"{kib:>8.0f} KiB  "
              f"{r['flops_per_step'] / 1e3:>8.0f} kFLOP/step", file=file)
    return rows


@contextlib.contextmanager
def trace_run(logdir: str):
    """``torch.profiler`` trace context: ``with trace_run('/tmp/trace'):
    sim.run(...)`` writes a Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``)
    into ``logdir``, for Perfetto, ``chrome://tracing`` or TensorBoard.
    Traces the host and, where there is one, the CUDA device; the
    program's spans recorded inside the context are added on a process
    row of their own (:data:`SPAN_ROW`), on the device records' time base.
    Yields the profiler (``key_averages()`` sums the events by name)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = time.perf_counter_ns()

    def ready(prof):
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                    f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, since)
    with profile(activities=activities, on_trace_ready=ready) as prof:
        yield prof


# ---------------------------------------------------------------------------
# The recorder: spans and counters
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One span of the program's host time.  ``parent``: the index in
    :func:`spans` of the span open around it (-1: none); ``start_ns`` and
    ``end_ns`` (0 while it is open): ``time.perf_counter_ns()``."""
    name: str
    parent: int
    start_ns: int
    end_ns: int


_records: List[list] = []   # [name, parent, start_ns, end_ns], by start
_open: List[int] = []       # indices of the open spans, innermost last
_counts: Dict[str, int] = {}
_forced = 0
_profiler_enabled = torch._C._autograd._profiler_enabled


def tracing_on() -> bool:
    """Whether :func:`span` records: while a ``torch.profiler`` profile
    records, or inside :func:`tracing`."""
    return _forced > 0 or _profiler_enabled()


@contextlib.contextmanager
def tracing():
    """Record spans inside the block, with no profiler running."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str):
        self.rec = [name, -1, 0, 0]

    def __enter__(self):
        rec = self.rec
        rec[1] = _open[-1] if _open else -1
        _open.append(len(_records))
        _records.append(rec)
        rec[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[3] = time.perf_counter_ns()
        if _open:
            _open.pop()
        return False


def span(name: str):
    """A context manager that records ``name``'s span while tracing is on
    (:func:`tracing_on`); otherwise one shared object that records
    nothing."""
    return _Span(name) if tracing_on() else _NO_SPAN


def spans() -> List[Span]:
    """The spans recorded since the last :func:`reset`, in the order they
    started."""
    return [Span(*r) for r in _records]


def self_ns(records: List[Span], i: int) -> int:
    """Span ``i``'s duration less the time its child spans cover."""
    s = records[i]
    return (s.end_ns - s.start_ns) - sum(
        c.end_ns - c.start_ns for c in records if c.parent == i)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (kept whether tracing or not)."""
    _counts[name] = _counts.get(name, 0) + n


def count_traced(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on
    (:func:`tracing_on`); nothing otherwise."""
    if tracing_on():
        count(name, n)


def counter(name: str) -> int:
    """The counter ``name`` since the last :func:`reset` (0 if never
    counted)."""
    return _counts.get(name, 0)


def reset() -> None:
    """Forget every span and counter."""
    _records.clear()
    _open.clear()
    _counts.clear()


def profiler_clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``: added to a span's
    stamps, it puts them on the clock ``torch.profiler`` stamps its CPU
    and CUDA records with (the Unix epoch).  The tightest of five
    bracketed reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


#: the Chrome trace's process row of the program's spans: a number no
#: Linux pid reaches (kineto's rows are the process's pid and the devices'
#: indices)
SPAN_ROW = 1 << 23


def _add_spans(path: str, since_ns: int) -> None:
    """Append the spans that started at or after ``since_ns`` to the
    Chrome trace at ``path``, on its time base (``baseTimeNanoseconds``
    before each event's microseconds)."""
    with open(path) as f:
        trace = json.load(f)
    shift = profiler_clock_offset_ns() - int(trace.get("baseTimeNanoseconds",
                                                       0))
    recs = spans()
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_ROW,
               "args": {"name": "program spans"}}]
    for s in recs:
        if s.start_ns >= since_ns and s.end_ns:
            events.append({
                "ph": "X", "cat": "program_span", "name": s.name,
                "pid": SPAN_ROW, "tid": 0,
                "ts": (s.start_ns + shift) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"parent": recs[s.parent].name
                         if s.parent >= 0 else None}})
    trace["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(trace, f)
