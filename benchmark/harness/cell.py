"""One run of one cell: set-up, the window, the traced slice, the check
against the reference, the metrics and the result line."""

from __future__ import annotations

import gc
import json
import time

from . import core, trace as tr


class Context:
    """What a run's entry, check and readers share."""

    def __init__(self, bench, cell, cfg, mix, seed, seconds, traced, device):
        self.bench, self.cell, self.cfg, self.mix = bench, cell, cfg, mix
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = device
        self.spans = core.Spans()
        self.timings = {}
        self.window = {}       # the window's work and time
        self.sliced = None     # the traced slice's work and reduction
        self.counts = {}       # operations and bytes from the reference
        self.checks = []       # (name, value, limit)
        self.entry_module = None


def run(bench, cell, cfg, mix, *, seed, seconds, trace, device,
        t_start) -> dict:
    """One whole run; returns the result."""
    ctx, entry, outputs, mem_peak = drive(
        bench, cell, cfg, mix, seed=seed, seconds=seconds, trace=trace,
        device=device, t_start=t_start)
    entry.reference_check(ctx, outputs)
    return finish(ctx, mem_peak)


def drive(bench, cell, cfg, mix, *, seed, seconds, trace, device,
          t_start):
    """Set-up, the window and the program's outputs for the check, with
    the program freed: (context, entry, outputs, peak device memory)."""
    import torch
    t_main = time.time()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_init = time.time()
    ctx = Context(bench, cell, cfg, mix, seed, seconds, trace, device)
    entry = core.entry_module(mix["entry"])
    ctx.entry_module = entry
    state = entry.setup(ctx)
    ctx.timings["build_s"] = ctx.spans.total("build")
    ctx.timings["warmup_s"] = ctx.spans.total("warmup")
    sync(device)
    t0 = time.perf_counter()
    ctx.timings["setup_s"] = time.time() - t_start
    core.log(f"set-up {ctx.timings['setup_s']:.3f} s: process start to "
             f"main {t_main - t_start:.3f} s, CUDA init "
             f"{t_init - t_main:.3f} s, " + ", ".join(
                 f"{n} {ctx.spans.total(n):.3f} s"
                 for n in dict.fromkeys(r[0] for r in ctx.spans.records)))
    window(ctx, entry, state, t0)
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    outputs = entry.program_outputs(ctx, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ctx, entry, outputs, mem_peak


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def window(ctx, entry, state, t0) -> None:
    """Drive the entry's units of work until ``seconds`` have passed; a
    traced run profiles ``trace_units`` units after the first one (and
    runs on until they are done)."""
    lead, n_traced = 1, entry.trace_units(ctx)
    units = ep_steps = 0
    prof = None
    times = []
    while True:
        tu = time.perf_counter()
        if ctx.traced and units == lead and prof is None \
                and ctx.sliced is None:
            prof = tr.profiler()
            prof.__enter__()
            ctx.spans.profiling = True
            sliced = {"units": 0, "ep_steps": 0}
            span = ctx.spans.span("traced")
            span.__enter__()
        e = entry.unit(ctx, state)
        times.append(time.perf_counter() - tu)
        units += 1
        ep_steps += e
        if ctx.sliced is not None:
            # the traced run's units after its slice and the profiler's
            # teardown: the rate its per-layer shares of a peak use
            after = ctx.sliced.setdefault("after", {"ep_steps": 0,
                                                    "seconds": 0.0})
            after["ep_steps"] += e
            after["seconds"] += times[-1]
        if prof is not None:
            sliced["units"] += 1
            sliced["ep_steps"] += e
            if sliced["units"] == n_traced:
                span.__exit__(None, None, None)
                ctx.spans.profiling = False
                prof.__exit__(None, None, None)
                sliced["wall_s"] = span.spans.records[-1][2] \
                    - span.spans.records[-1][1]
                sliced["prof"] = prof
                ctx.sliced = sliced
                prof = None
        if time.perf_counter() - t0 >= ctx.seconds and (
                not ctx.traced or ctx.sliced is not None):
            break
    seconds = time.perf_counter() - t0
    ctx.window.update(units=units, ep_steps=ep_steps, seconds=seconds,
                      episode_steps_per_s=ep_steps / seconds)
    q = sorted(times)
    core.log(f"window: {units} units, {ep_steps} episode-steps in "
             f"{seconds:.3f} s; unit s min {q[0]:.6f} median "
             f"{q[len(q) // 2]:.6f} max {q[-1]:.6f}, first {times[0]:.6f} "
             f"last {times[-1]:.6f}")
    if ctx.traced:
        dev, spans = tr.records(ctx.sliced.pop("prof"))
        ctx.sliced["trace"] = tr.reduce(dev, spans)
        s = ctx.sliced
        after = s.get("after", {})
        rate = (after["ep_steps"] / after["seconds"]
                if after.get("seconds") else float("nan"))
        core.log(f"traced slice: {s['units']} units, {s['ep_steps']} "
                 f"episode-steps in {s['wall_s']:.4f} s "
                 f"({s['ep_steps'] / s['wall_s']:.1f} episode-steps/s "
                 f"traced; after the profiler stopped: {rate:.1f})")


def finish(ctx, mem_peak) -> dict:
    import torch
    bench, name = ctx.bench, ctx.cell["name"]
    metrics = {}
    if not ctx.traced:
        for m in core.metrics_of(bench, name, "end_to_end"):
            v = ctx.window.get(m["name"]) if m["name"] != "setup_s" \
                else ctx.timings["setup_s"]
            if v is None:
                raise RuntimeError(f"{name} does not report {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in core.metrics_of(bench, name, "per_layer"):
            v = core.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(mem_peak)}
    out = {"correct": all(v <= lim for _, v, lim in ctx.checks),
           "attempted": ctx.window.get("attempted", 1),
           "failed": ctx.window.get("failed", 0),
           "metrics": metrics, "device": device}
    if ctx.traced:
        t = ctx.sliced["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in ctx.checks}
    return out


def emit(result: dict) -> None:
    """Print the compared numbers beside their limits (the last lines of
    standard error) and the result (the last line of standard output)."""
    info = core.card_info()
    core.log(f"card: {info['smi_name']}, power limit {info['power_limit']}, "
             f"SM clock {info['sm_clock']}")
    for n, c in result["compared"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        core.log(f"compared {n}: {c['value']!r} (limit {c['limit']!r}) {ok}")
    print(json.dumps(result), flush=True)

