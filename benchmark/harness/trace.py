"""A traced slice of the window and its reduction to device time.

The profiler's raw records are read in memory (``kineto_results``), as the
program's own probe reads them; nothing is exported.  Device busy time is
the union of the device records' intervals, so overlapping records count
once; idle gaps are named by the harness span that was open at the time.
"""

from __future__ import annotations

from collections import defaultdict


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def records(prof):
    """(device records, harness spans): each a list of (name, start ns,
    end ns) on the trace's clock.  Device records are the CUDA kernels,
    copies and fills; spans the ``bench.*`` ranges."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            # the harness's ranges mirrored on the device's timeline are
            # annotations, not device work
            if not e.name().startswith("bench."):
                dev.append((e.name(), e.start_ns(), e.end_ns()))
        else:
            name = e.name()
            if name.startswith("bench."):
                spans.append((name[len("bench."):], e.start_ns(),
                              e.end_ns()))
    return dev, spans


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy",
                                "cudaMemset"))


def reduce(dev, spans, window: str = "traced", top: int = 10) -> dict:
    """The traced slice (the ``window`` span) reduced: its length, the
    device's busy time in it, its kernels and their self time, the ``top``
    device operations by time and the ``top`` idle-gap totals by the
    innermost span open at each gap."""
    win = [s for s in spans if s[0] == window]
    if not win:
        raise RuntimeError(f"no '{window}' span in the trace")
    _, t0, t1 = win[0]
    inside = [(n, a, b) for n, a, b in dev if b > t0 and a < t1]
    merged = merge([(max(a, t0), min(b, t1)) for _, a, b in inside])
    busy = sum(b - a for a, b in merged)
    kernels = [(n, a, b) for n, a, b in inside if is_kernel(n)]
    by_name = defaultdict(float)
    for n, a, b in inside:
        by_name[n] += (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    inner = sorted((s for s in spans if s[0] != window),
                   key=lambda s: s[2] - s[1])
    gaps = defaultdict(float)
    prev = t0
    for a, b in merged + [[t1, t1]]:
        if a > prev:
            mid = (prev + a) / 2
            name = next((n for n, sa, sb in inner if sa <= mid <= sb),
                        "harness")
            gaps[name] += (a - prev) / 1e9
        prev = max(prev, b)
    out = {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
           "kernels": len(kernels),
           "kernel_s": sum(b - a for _, a, b in kernels) / 1e9,
           "device_ops": [[n, s] for n, s in ops],
           "idle_gaps": [[n, s] for n, s in
                         sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
           "kernel_times": defaultdict(list)}
    for n, a, b in kernels:
        out["kernel_times"][n].append((b - a) / 1e9)
    return out
