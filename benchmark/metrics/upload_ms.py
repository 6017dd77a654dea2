"""Milliseconds an episode spends in ``pi.upload``: the velocity and
correction tables to the device (a pageable copy each), per ``pi.run`` of
the traced slice."""
from benchmark.harness import program_spans as ps


def read(ctx):
    return ps.child_ms(ctx, "pi.upload")
