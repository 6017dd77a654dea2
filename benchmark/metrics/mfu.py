"""The entry's model FLOPs a simulated episode-step (``flops_per_step``)
times the traced run's episode-steps a second outside its slice (after
the profiler has stopped: the profiler slows the slice itself), over the
float32 peak, in %."""
from benchmark.harness import counts


def read(ctx):
    s = ctx.sliced
    per_step = getattr(ctx.entry_module, "flops_per_step", None)
    if s is None or per_step is None \
            or not s.get("after", {}).get("seconds"):
        return None
    flops = per_step(ctx)
    if flops is None:
        return None
    rate = s["after"]["ep_steps"] / s["after"]["seconds"]
    return 100.0 * flops * rate / counts.PEAK_F32
