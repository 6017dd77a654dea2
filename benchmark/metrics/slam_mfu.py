"""The SLAM step's model operations (``harness/slam_counts.py``) times the
traced run's steps a second outside its slice (after the profiler has
stopped: the profiler slows the slice itself), over the float32 peak, in
%."""
from benchmark.harness import counts, slam_counts


def read(ctx):
    s = ctx.sliced
    if s is None or not s.get("after", {}).get("seconds") \
            or not s["trace"]["kernels"]:
        return None
    rate = s["after"]["ep_steps"] / s["after"]["seconds"]
    return 100.0 * slam_counts.step(ctx.cfg)["flops"] * rate \
        / counts.PEAK_F32
