"""Device time of the bench SLAM step from the profiler's CUDA records.

Port of the JAX package's ``experiments/device_time_probe.py``: wall-clock
steps/s moves with the host (dispatch, other load), the device's own
record of its kernels does not.  This builds ``bench.py --model slam``'s
model (``sspslam_tpu_torch.bench.build``), runs one warm-up segment (the
CUDA graphs' capture included), traces ``--steps`` replayed steps with
``torch.profiler`` (CPU and CUDA activities) and reports the CUDA kernels'
self time per step, the kernels per step, the device's busy share of the
traced window (the union of its records, so overlapping records count
once) and the costliest kernels: the number to compare
step-level changes by.  ``torch.profiler`` takes the place of XLA's
per-op accounting.

    python -m sspslam_tpu_torch.experiments.device_time_probe \\
        [--steps 2000] [--segment-steps 1000] [--top 8] [--device cuda]

Ends with one JSON line, ``{"metric": "SLAM device us/step", ...}``.  On
``--device cpu`` the device time is None (no device records); on a CUDA
device a trace without a CUDA kernel is an error.  ``--scan-unroll`` is
not carried (the Simulator replays CUDA graphs).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from .. import bench

#: replayed steps traced, in segments of SEGMENT (bench.py's probe traced
#: one 10,000-step segment of XLA ops; every kernel of a replayed graph is
#: one CUDA record here, so the window is shorter)
STEPS, SEGMENT = 2000, 1000


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint [start,
    end] pairs: overlapping device records (a copy beside a kernel, two
    streams) count once."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that some interval covers."""
    return sum(b - a for a, b in merge(
        (max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi))


def profile_steps(run, steps: int, top: Optional[int] = 6) -> dict:
    """Trace ``run()``, which advances ``steps`` steps and waits for the
    device, with ``torch.profiler``.  Returns, per step: the CUDA kernels'
    self time (``device_us_per_step``), the kernels, the device records
    (kernels, copies and fills) and their busy time (the union of their
    intervals inside the traced wall window); the busy share of that
    window; and the ``top`` kernels by time (None: every kernel), as
    (name, us per step, calls per step).  Raises when the trace holds no
    CUDA kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler's own clock (the Unix epoch), which stamps its
        # records
        t0 = time.time_ns()
        run()
        t1 = time.time_ns()
    # the raw records: building the profiler's Python event objects for a
    # few hundred thousand kernels takes longer than the traced run
    dev = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    kernels = [(n, (b - a) / 1e3) for n, a, b in dev
               if not n.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    by_name = {}
    for name, us in kernels:
        t, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    busy_us = busy_ns([(a, b) for _, a, b in dev], t0, t1) / 1e3
    return {"steps": steps,
            "device_us_per_step": sum(us for _, us in kernels) / steps,
            "kernels_per_step": len(kernels) / steps,
            "events_per_step": len(dev) / steps,
            "busy_us_per_step": busy_us / steps,
            "busy_share": busy_us / ((t1 - t0) / 1e3),
            "top": [(name, t / steps, calls / steps)
                    for name, (t, calls) in ranked]}


def measure_device_time(sim, steps: int = STEPS, seg: int = SEGMENT,
                        top: int = 6) -> Optional[dict]:
    """:func:`profile_steps` over the next ``steps`` steps of ``sim`` in
    segments of ``seg`` (its graphs captured and its inputs preloaded
    already, so the window holds replays only); None on the CPU, which
    has no device records."""
    if sim.device.type != "cuda":
        return None

    def run():
        sim.run_steps(steps, segment_steps=seg)
        sim.sync()
    return profile_steps(run, steps, top)


def warmed_bench_model(args, steps: int):
    """``bench.build`` at ``args``' widths with the inputs of one
    ``args.segment_steps`` warm-up segment and ``steps`` more steps
    preloaded on the device, after the warm-up segment (the capture
    included).  Returns the simulator."""
    sim, _, _, _ = bench.build(args)
    seg = args.segment_steps
    sim.preload_inputs(seg + steps)
    t0 = time.perf_counter()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    bench.log(f"capture+warmup ({seg} steps): {time.perf_counter() - t0:.1f}s")
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    bench.add_model_args(ap)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--segment-steps", type=int, default=SEGMENT)
    ap.add_argument("--top", type=int, default=8,
                    help="print the top-N kernels by time")
    args = ap.parse_args(argv)

    sim = warmed_bench_model(args, args.steps)
    prof = measure_device_time(sim, args.steps, args.segment_steps, args.top)
    card = bench.card(sim.device)
    if prof is None:
        print(f"device time: not measured on {sim.device} (no device "
              "records)")
    else:
        print(f"device time: {prof['device_us_per_step']:.3f} us/step "
              f"({args.steps} steps, {prof['kernels_per_step']:.2f} "
              f"kernels/step, device busy {prof['busy_share'] * 100:.1f} % "
              f"of the window; {card['device_name']}, "
              f"{card['power_limit_w']} W)")
        for name, us, calls in prof["top"]:
            print(f"  {us:7.3f} us/step  {calls:6.2f} x  {name[:100]}")
    out = {"metric": "SLAM device us/step",
           "value": None if prof is None else prof["device_us_per_step"],
           "unit": "us/step", "steps": args.steps,
           "kernels_per_step": None if prof is None
           else prof["kernels_per_step"],
           "busy_share": None if prof is None else prof["busy_share"],
           **card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
