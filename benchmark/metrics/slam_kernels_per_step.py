"""Kernels a SLAM step launches: the traced slice's kernel records over
its ``sim.steps``."""
from benchmark.harness import sim_spans


def read(ctx):
    s, n = ctx.sliced, sim_spans.steps(ctx)
    if s is None or n is None or not s["trace"]["kernels"]:
        return None
    return s["trace"]["kernels"] / n
