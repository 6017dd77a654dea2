"""Microseconds of host time a ``vco_scan`` call takes (its
``vco_scan.call`` span: on the card the argument checks, the device
queries, the launch and the output projection's enqueue), averaged over
the calls of the traced slice's ``pi.run`` spans."""
from benchmark.harness import program_spans as ps


def read(ctx):
    calls = [ps.ns(c) for _, kids in ps.runs(ctx) or ()
             for c in kids["vco_scan.call"]]
    if not calls:
        return None
    return sum(calls) / len(calls) / 1e3
