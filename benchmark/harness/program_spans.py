"""The program's own spans (``sspslam_tpu_torch.utils.profiling``) inside
a run's traced slice, for the readers of the fast path's host loop.

The program stamps its spans with ``time.perf_counter_ns()``, the clock of
the harness's spans (``time.perf_counter()``), so a span lies in the slice
when it starts and ends inside the harness's ``traced`` span; spans of
earlier runs in the same process lie outside it.  A program that keeps no
spans reads as None.
"""

from __future__ import annotations

from collections import defaultdict


def ns(s) -> int:
    return s.end_ns - s.start_ns


def runs(ctx):
    """Each ``pi.run`` span of the traced slice as (the span, {child name:
    [its child spans of that name]}); None when there is none."""
    try:
        from sspslam_tpu_torch.utils import profiling
        records = profiling.spans()
    except (ImportError, AttributeError):
        return None
    win = [(a, b) for n, a, b in ctx.spans.records if n == "traced"]
    if not win:
        return None
    t0, t1 = (round(t * 1e9) for t in win[-1])
    chosen = [i for i, s in enumerate(records) if s.name == "pi.run"
              and t0 <= s.start_ns and 0 < s.end_ns <= t1]
    if not chosen:
        return None
    kids = {i: defaultdict(list) for i in chosen}
    for s in records:
        if s.parent in kids:
            kids[s.parent][s.name].append(s)
    return [(records[i], kids[i]) for i in chosen]


def child_ms(ctx, name):
    """The ``name`` children's milliseconds per ``pi.run`` of the slice,
    averaged over them; None without a ``pi.run``."""
    rs = runs(ctx)
    if not rs:
        return None
    return sum(ns(c) for _, kids in rs for c in kids[name]) / len(rs) / 1e6
