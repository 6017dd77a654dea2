"""Tiny widths of the configuration and short mixes, for the benchmark's
CPU tests: the same code paths as a run at the cell's size."""

from __future__ import annotations

SIZES = dict(ssp_dim=25, pi_n_neurons=60)

MIX = dict(episode_s=2.0, limit=2.0, chunk_steps=1000, pool=4,
           check_within=3, trace_episodes=1)


def shrink(cfg: dict, mix: dict):
    """(cfg, mix) cut to the tiny widths."""
    return dict(cfg, **SIZES), dict(mix, **MIX)
