"""Microseconds of device time a SLAM step takes: the union of the device
records that the traced slice's ``sim.replay`` spans launched, over the
slice's ``sim.steps``."""
from benchmark.harness import sim_spans


def read(ctx):
    busy, n = sim_spans.replay_device_ns(ctx), sim_spans.steps(ctx)
    if busy is None or n is None:
        return None
    return busy / n / 1e3
