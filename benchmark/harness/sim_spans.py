"""The Simulator's spans and counters (``sspslam_tpu_torch.utils.
profiling``: ``sim.run_steps`` ⊃ ``sim.stage``, ``sim.capture``,
``sim.replay``, ``sim.wait``, ``sim.probes``; ``sim.steps``) inside a
run's traced slice, and the device records its replays launched, for the
SLAM cells' readers.

A program without these spans or counters (an older one) reads as None.
"""

from __future__ import annotations

from collections import defaultdict

from . import trace as tr


def _profiling():
    try:
        from sspslam_tpu_torch.utils import profiling
        profiling.spans, profiling.counter  # noqa: B018
        return profiling
    except (ImportError, AttributeError):
        return None


def _slice_ns(ctx):
    win = [(a, b) for n, a, b in ctx.spans.records if n == "traced"]
    if not win:
        return None
    return tuple(round(t * 1e9) for t in win[-1])


def runs(ctx):
    """Each ``sim.run_steps`` span of the traced slice as (the span, {child
    name: [its child spans]}); None when there is none."""
    p, win = _profiling(), _slice_ns(ctx)
    if p is None or win is None:
        return None
    records = p.spans()
    t0, t1 = win
    chosen = [i for i, s in enumerate(records) if s.name == "sim.run_steps"
              and t0 <= s.start_ns and 0 < s.end_ns <= t1]
    if not chosen:
        return None
    kids = {i: defaultdict(list) for i in chosen}
    for s in records:
        if s.parent in kids:
            kids[s.parent][s.name].append(s)
    return [(records[i], kids[i]) for i in chosen]


def steps(ctx):
    """The ``sim.steps`` counter: the steps run while tracing (the slice's
    in a benchmark run); None when it counted none."""
    p = _profiling()
    n = p.counter("sim.steps") if p is not None else 0
    return n or None


def ns(s) -> int:
    return s.end_ns - s.start_ns


def replay_device_ns(ctx):
    """The union of the device records that the slice's ``sim.replay``
    spans launched (a record's correlation id is its launch's), in ns;
    None without the slice's profile, its replays or such records."""
    prof = getattr(ctx, "slam_prof", None)
    rs = runs(ctx)
    p = _profiling()
    if prof is None or not rs or p is None:
        return None
    from torch.autograd import DeviceType
    off = p.profiler_clock_offset_ns()
    wins = sorted((s.start_ns + off, s.end_ns + off)
                  for _, kids in rs for s in kids["sim.replay"])
    if not wins:
        return None
    events = list(prof.profiler.kineto_results.events())
    launched = set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            continue
        t = e.start_ns()
        if any(a <= t <= b for a, b in wins):
            launched.add(e.correlation_id())
    launched.discard(0)
    dev = [(e.start_ns(), e.end_ns()) for e in events
           if e.device_type() == DeviceType.CUDA
           and not e.name().startswith("bench.")
           and e.correlation_id() in launched]
    if not dev:
        return None
    return sum(b - a for a, b in tr.merge(dev))
