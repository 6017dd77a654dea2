"""Milliseconds of a unit's ``Simulator.run_steps`` that the host holds
and the device's work does not cover: each ``sim.run_steps`` span of the
traced slice less its ``sim.replay`` (enqueuing the graphs) and
``sim.wait`` (the host blocked on the card) children, averaged over the
slice's units."""
from benchmark.harness import sim_spans as ss


def read(ctx):
    rs = ss.runs(ctx)
    if not rs:
        return None
    return sum(ss.ns(r) - sum(ss.ns(c) for name in ("sim.replay", "sim.wait")
                                for c in kids[name])
               for r, kids in rs) / len(rs) / 1e6
