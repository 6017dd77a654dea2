"""Tiny widths of the SLAM configuration and a short mix, for the SLAM
cells' CPU tests: the same code paths as a run at the cell's size."""

from __future__ import annotations

SIZES = dict(ssp_dim=25, length_scale=0.6, pi_n_neurons=40, mem_n_neurons=60,
             circonv_n_neurons=20, n_landmarks=5, view_rad=0.8,
             cleanup_samples_per_dim=30)

MIX = dict(world_s=20.0, limit=0.1, unit_steps=100, check_within=5,
           trace_units=1, track_every=10)

#: a correction moves the tiny path integrator (40 LIF a VCO) less within
#: the K judged steps than the cell's (800): its chunk limit sits between
#: the tiny sound run's reading (about 1e-5) and a shut gate's
LIMITS = dict(chunk_gap=0.01)


def shrink(cfg: dict, mix: dict):
    """(cfg, mix) cut to the tiny widths."""
    return dict(cfg, **SIZES), dict(mix, **MIX,
                                    limits=dict(mix["limits"], **LIMITS))
