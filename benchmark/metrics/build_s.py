"""Seconds of the entry's ``build`` span on the host clock: the program's
SSP space and its network's construction (encoders, gains, biases,
decoder solves)."""


def read(ctx):
    return ctx.timings.get("build_s")
