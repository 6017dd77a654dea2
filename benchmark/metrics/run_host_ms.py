"""Milliseconds of an episode's ``FastPathIntegrator.run`` that the host
holds and the device's work does not cover: each ``pi.run`` span of the
traced slice less its ``pi.wait`` child (the host blocked on the card),
averaged over the slice's episodes."""
from benchmark.harness import program_spans as ps


def read(ctx):
    rs = ps.runs(ctx)
    if not rs:
        return None
    return sum(ps.ns(r) - sum(ps.ns(w) for w in kids["pi.wait"])
               for r, kids in rs) / len(rs) / 1e6
