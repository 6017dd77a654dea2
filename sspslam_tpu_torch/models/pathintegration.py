"""Path-integration network: a bank of velocity-controlled oscillators (VCOs)
with attractor dynamics, holding an SSP self-position estimate in the
Fourier domain.

Port of :class:`sspslam_tpu.models.pathintegration.PathIntegration` (the
network description is NumPy, so the port is the same code over the port's
graph): the (d+1)//2 VCO populations are ONE batched EnsembleArray;
velocity enters every VCO through one batched (k, 3, N) transform; the
recurrent limit-cycle feedback is one batched decoded connection.  The
``Reencode``, ``GC`` and ``BCsGCs`` variants are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..nef import (BatchedConnection, Choice, Connection, Ensemble,
                   EnsembleArray, Network, Node)
from ..ops import vsa
from ..utils.sampling import sparsity_to_x_intercept

__all__ = ["PathIntegration", "get_to_Fourier", "get_from_Fourier",
           "vco_feedback"]


def get_to_Fourier(d: int) -> np.ndarray:
    """SSP -> stacked VCO-triple Fourier layout (3k x d)."""
    return vsa.to_fourier_matrix(d)


def get_from_Fourier(d: int) -> np.ndarray:
    """Stacked VCO-triple Fourier layout -> SSP (d x 3k)."""
    return vsa.from_fourier_matrix(d)


def vco_feedback(recurrent_tau, scaling_factor, length_scale, max_radius=1.0,
                 stable=True):
    """The per-VCO recurrent function: a Hopf-style limit cycle (stable=True)
    or a plain harmonic rotation, with the third state (omega) decoded to 0."""
    ls = float(np.asarray(length_scale).flat[0])

    if callable(stable):
        return stable

    if stable:
        def feedback(x):
            w = x[2] / (scaling_factor * ls)
            r = np.maximum(np.sqrt(x[0]**2 + x[1]**2), 1e-9)
            dx0 = x[0] * (max_radius**2 - r**2) / r - x[1] * w
            dx1 = x[1] * (max_radius**2 - r**2) / r + x[0] * w
            return np.array([recurrent_tau * dx0 + x[0],
                             recurrent_tau * dx1 + x[1], 0.0])
    else:
        def feedback(x):
            w = x[2] / (scaling_factor * ls)
            return np.array([x[0] - recurrent_tau * x[1] * w,
                             x[1] + recurrent_tau * x[0] * w, 0.0])
    return feedback


def _velocity_transforms(phase_matrix: np.ndarray, k: int) -> np.ndarray:
    """(k, 3, N) batched transforms: VCO j's third dim receives A[j] . v."""
    N = phase_matrix.shape[1]
    W = np.zeros((k, 3, N))
    W[:, 2, :] = phase_matrix[:k, :]
    return W


class PathIntegration(Network):
    """VCO-bank path integrator.

    Attributes: ``velocity_input`` (N), ``input`` (d; corrections /
    initialisation), ``oscillators`` (batched EnsembleArray of k 3-D VCOs),
    ``output`` (d; SSP estimate — an Ensemble of grid cells if
    ``with_gcs``).
    """

    def __init__(self, ssp_space, n_neurons, recurrent_tau=0.05,
                 scaling_factor=1, stable=True, max_radius=1,
                 with_gcs=False, n_gcs=1000, solver_weights=False,
                 label="pathint", **kwargs):
        super().__init__(label=label)
        d = ssp_space.ssp_dim
        N = ssp_space.domain_dim
        k = (d + 1) // 2

        feedback = vco_feedback(recurrent_tau, scaling_factor,
                                ssp_space.length_scale, max_radius, stable)
        to_SSP = get_from_Fourier(d)
        to_Fourier = get_to_Fourier(d)
        self.to_SSP = to_SSP
        self.to_Fourier = to_Fourier

        with self:
            self.velocity_input = Node(size_in=N, label=f"{label}_vel_input")
            self.input = Node(size_in=d, label=f"{label}_input")
            if with_gcs:
                encoders = ssp_space.sample_grid_encoders(n_gcs)
                self.output = Ensemble(
                    n_gcs, d, encoders=encoders,
                    intercepts=Choice([sparsity_to_x_intercept(d, 0.1)]),
                    label=f"{label}_output")
            else:
                self.output = Node(size_in=d, label=f"{label}_output")

            self.oscillators = EnsembleArray(
                n_neurons, k, ens_dimensions=3, radius=np.sqrt(2),
                label=f"{label}_vco", **kwargs)

            # SSP corrections scatter into every VCO through the fixed DFT map
            Connection(self.input, self.oscillators.input,
                       transform=to_Fourier, synapse=None)

            # velocity drives each VCO's frequency dim (A[0] == 0: DC inert)
            BatchedConnection(self.velocity_input, self.oscillators,
                              transforms=_velocity_transforms(
                                  ssp_space.phase_matrix, k),
                              synapse=None)

            # batched recurrent limit-cycle dynamics (VCO 0 pinned instead)
            mask = np.ones(k)
            mask[0] = 0.0
            self.recurrent = BatchedConnection(
                self.oscillators, self.oscillators, function=feedback,
                synapse=recurrent_tau, element_mask=mask,
                solver_weights=solver_weights)

            # DC term held at [1, 0, 0]
            zerofreq = Node([1.0, 0.0, 0.0], label=f"{label}_zerofreq")
            Connection(zerofreq, self.oscillators.ea_ensembles[0],
                       synapse=None)

            Connection(self.oscillators.output, self.output,
                       transform=to_SSP, synapse=None)
