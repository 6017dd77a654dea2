"""The VCO kernel's least time for a chunk (its spikes counted by the
reference's run of the judged episode) over the kernel's mean record time
in the traced slice, in %."""
from benchmark.harness import counts


def read(ctx):
    s, c = ctx.sliced, ctx.counts
    if s is None or "chunk_spikes" not in c:
        return None
    times = [t for name, ts in s["trace"]["kernel_times"].items()
             if "vco_scan" in name for t in ts]
    if not times:
        return None
    spikes = sum(c["chunk_spikes"]) / len(c["chunk_spikes"])
    least = counts.vco_chunk(c["n"], c["k"], c["d"], c["N"], c["T"],
                             spikes)["least_s"]
    return 100.0 * least / (sum(times) / len(times))
