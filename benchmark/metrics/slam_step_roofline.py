"""The SLAM step's least time (its operations and bytes from
``harness/slam_counts.py``, counted from the reference's shapes) over its
device time (``slam_step_device_us``), in %."""
from benchmark.harness import sim_spans, slam_counts


def read(ctx):
    busy, n = sim_spans.replay_device_ns(ctx), sim_spans.steps(ctx)
    if busy is None or n is None:
        return None
    return 100.0 * slam_counts.step(ctx.cfg)["least_s"] / (busy / n / 1e9)
