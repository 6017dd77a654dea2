"""Seconds of the entry's ``warmup`` span on the host clock, from the
build to the window: input tables and the first calls (the kernel's build
in a fresh checkout, and its first launches)."""


def read(ctx):
    return ctx.timings.get("warmup_s")
