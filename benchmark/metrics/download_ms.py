"""Milliseconds an episode spends in ``pi.download``: the chunk traces
joined and copied to the host, after ``pi.wait``, per ``pi.run`` of the
traced slice."""
from benchmark.harness import program_spans as ps


def read(ctx):
    return ps.child_ms(ctx, "pi.download")
