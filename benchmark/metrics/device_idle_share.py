"""The share of the traced slice in which no device record ran, in %:
100 x (1 - the union of device records / the slice)."""


def read(ctx):
    s = ctx.sliced
    if s is None or not s["trace"]["window_s"] or not s["trace"]["busy_s"]:
        return None
    return 100.0 * (1.0 - s["trace"]["busy_s"] / s["trace"]["window_s"])
