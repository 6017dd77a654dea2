"""Synapse models as one-pole IIR filters (state carried between steps).

A NumPy copy of :mod:`sspslam_tpu.ops.synapses`.  The reference uses ``nengo.Lowpass`` on every connection/probe
(tau in {0.01, 0.05, 0.1}; e.g. slam.py:271-307).  Here a synapse is a pair
of scalars (decay a, gain b): y' = a*y + b*u, discretised with zero-order
hold — so filtering an entire network's connections is one fused multiply-add
over a concatenated state vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Synapse", "Lowpass", "Alpha", "coefficients"]


@dataclasses.dataclass(frozen=True)
class Synapse:
    pass


@dataclasses.dataclass(frozen=True)
class Lowpass(Synapse):
    """First-order lowpass 1/(tau s + 1).  tau == 0 gives a pure one-step
    delay (y' = u)."""

    tau: float

    def coefficients(self, dt: float):
        if self.tau <= 0.0:
            return 0.0, 1.0
        a = float(np.exp(-dt / self.tau))
        return a, 1.0 - a


@dataclasses.dataclass(frozen=True)
class Alpha(Synapse):
    """Second-order alpha synapse 1/(tau s + 1)^2, implemented as two cascaded
    lowpass stages; state shape doubles."""

    tau: float

    def coefficients(self, dt: float):
        if self.tau <= 0.0:
            return 0.0, 1.0
        a = float(np.exp(-dt / self.tau))
        return a, 1.0 - a


def coefficients(synapse, dt: float):
    """Normalize a synapse spec (None | float tau | Synapse) to (a, b, stages).

    ``None`` means an unfiltered same-step connection (handled by the builder,
    not here)."""
    if synapse is None:
        raise ValueError("synapse=None has no filter coefficients")
    if isinstance(synapse, (int, float)):
        synapse = Lowpass(float(synapse))
    a, b = synapse.coefficients(dt)
    stages = 2 if isinstance(synapse, Alpha) else 1
    return a, b, stages
