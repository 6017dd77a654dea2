"""Path-integration network: a bank of velocity-controlled oscillators (VCOs)
with attractor dynamics, holding an SSP self-position estimate in the
Fourier domain.

Port of :mod:`sspslam_tpu.models.pathintegration` (the network
description is NumPy, so the port is the same code over the port's graph):
the (d+1)//2 VCO populations are ONE batched EnsembleArray; velocity
enters every VCO through one batched (k, 3, N) transform; the recurrent
limit-cycle feedback is one batched decoded connection.

Variants: :class:`PathIntegrationReencode` (a periodic clean-up re-encoding
correction, a node function whose sample bank is hoisted onto the
Simulator's device), :class:`PathIntegrationGC` (3 VCOs per 9-D grid-cell
module, optional Kuramoto coupling) and :class:`PathIntegrationBCsGCs`
(6-D grid-cell populations feeding cube-root phase-consistency
corrections back into oscillator pairs); ``PathIntegrationOld`` is an
alias of :class:`PathIntegration`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nef import (BatchedConnection, Choice, Connection, Ensemble,
                   EnsembleArray, Network, Node)
from ..ops import vsa
from ..utils.sampling import sparsity_to_x_intercept

__all__ = ["PathIntegration", "PathIntegrationOld", "PathIntegrationReencode",
           "PathIntegrationGC", "PathIntegrationBCsGCs", "get_to_Fourier",
           "get_from_Fourier", "vco_feedback"]


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


class PathIntegrationReencode(PathIntegration):
    """PathIntegration plus a periodic clean-up: while ``t mod cleanup_dt``
    is under 10 ms the decoded SSP is snapped to the nearest sample-bank
    SSP and the difference re-injected through the Fourier map.  The
    clean-up is a node function in the step (argmax over the bank in
    :func:`vsa.default_cleanup_dtype`, the row gathered from the float32
    bank); the bank is its ``hoisted_consts``.  ``t`` is the step's device
    tensor, so a captured graph reads each replayed step's own time."""

    def __init__(self, ssp_space, n_neurons, recurrent_tau=0.05,
                 scaling_factor=1, stable=True, max_radius=1,
                 with_gcs=False, n_gcs=1000, solver_weights=False,
                 cleanup_dt=1.0, cleanup_samples_per_dim=100,
                 label="pathint", **kwargs):
        super().__init__(ssp_space, n_neurons, recurrent_tau=recurrent_tau,
                         scaling_factor=scaling_factor, stable=stable,
                         max_radius=max_radius, with_gcs=with_gcs,
                         n_gcs=n_gcs, solver_weights=solver_weights,
                         label=label, **kwargs)
        d = ssp_space.ssp_dim
        sample_ssps, _ = ssp_space.get_sample_pts_and_ssps(
            cleanup_samples_per_dim)
        bank = torch.as_tensor(np.asarray(sample_ssps, np.float32))
        hoisted = {"bank": bank.numpy(),
                   "bank_sim": bank.to(vsa.default_cleanup_dtype())}

        def cleanup_fun(t, x, consts=None):
            if consts is None:
                consts = {k: torch.as_tensor(v).to(x.device)
                          for k, v in hoisted.items()}
            cleaned = vsa.nearest_row(consts["bank"], consts["bank_sim"], x)
            # fmod is exact, as jnp.mod is for a positive t
            active = torch.fmod(torch.as_tensor(t, device=x.device),
                                cleanup_dt) < 0.01
            return torch.where(active, cleaned - x, 0.0)

        cleanup_fun.hoisted_consts = hoisted
        # a sharded step holds these as row shards (vsa.nearest_row)
        cleanup_fun.row_sharded = ("bank", "bank_sim")

        def _cleanup_np(t, x, consts=None):
            # the host interpreter's mirror (the JAX package's, on the
            # hoisted bank)
            x = np.asarray(x, np.float32)
            if float(t) % cleanup_dt < 0.01:
                b = np.asarray((hoisted if consts is None
                                else consts)["bank"], np.float32)
                return b[int(np.argmax(b @ x))] - x
            return np.zeros_like(x)
        cleanup_fun.np_function = _cleanup_np

        with self:
            cleanup = Node(cleanup_fun, size_in=d, size_out=d,
                           label=f"{label}_cleanup")
            Connection(self.oscillators.output, cleanup,
                       transform=self.to_SSP, synapse=0.005)
            Connection(cleanup, self.oscillators.input,
                       transform=self.to_Fourier, synapse=0.005)


def _gc_feedback(recurrent_tau, scaling_factor, length_scale, max_radius,
                 coupling, coupling_factor):
    """9-D feedback for a module of 3 VCOs, optionally Kuramoto-coupled."""
    ls = float(np.asarray(length_scale).flat[0])
    K = coupling_factor

    def feedback(x):
        w = [x[2] / (scaling_factor * ls),
             x[5] / (scaling_factor * ls),
             x[8] / (scaling_factor * ls)]
        re = [x[0], x[3], x[6]]
        im = [x[1], x[4], x[7]]
        r = [max(np.sqrt(re[i]**2 + im[i]**2), 1e-9) for i in range(3)]
        if coupling:
            # phase pulling between the three oscillators of the module
            def cross(i, j):  # sin(theta_j - theta_i) scaled
                return (im[j] * re[i] - re[j] * im[i])
            for i in range(3):
                others = [j for j in range(3) if j != i]
                w[i] = w[i] + (K / 2) * sum(
                    cross(i, j) / r[j] - (-cross(i, j)) / r[i]
                    for j in others)
        out = np.zeros(9)
        for i in range(3):
            dre = re[i] * (max_radius**2 - r[i]**2) / r[i] - im[i] * w[i]
            dim = im[i] * (max_radius**2 - r[i]**2) / r[i] + re[i] * w[i]
            out[3 * i] = recurrent_tau * dre + re[i]
            out[3 * i + 1] = recurrent_tau * dim + im[i]
        return out

    return feedback


class PathIntegrationGC(Network):
    """Grid-cell-module path integrator (2-D only): 3 VCOs per 9-D ensemble,
    optional Kuramoto coupling within each module."""

    def __init__(self, ssp_space, n_neurons, recurrent_tau=0.05,
                 scaling_factor=1, stable=True, max_radius=1,
                 coupling_factor=0.1, solver_weights=False, coupling=False,
                 label="pathint", **kwargs):
        super().__init__(label=label)
        d = ssp_space.ssp_dim
        N = ssp_space.domain_dim
        assert N == 2, "PathIntegrationGC is a 2-D (grid-cell) construction"
        n_oscs = (d - 1) // 2
        assert n_oscs % 3 == 0, (
            "ssp_dim must give a multiple of 3 oscillators (hexagonal space)")
        n_modules = 1 + n_oscs // 3

        to_SSP = get_from_Fourier(d)
        to_Fourier = get_to_Fourier(d)
        self.to_SSP = to_SSP
        self.to_Fourier = to_Fourier

        feedback = _gc_feedback(recurrent_tau, scaling_factor,
                                ssp_space.length_scale, max_radius,
                                coupling, coupling_factor)

        # module layout: flat position of triple j is 6 + 3j; module m covers
        # flat [9m, 9m+9).  Module 0 holds only the DC triple at dims 6:9.
        k = (d + 1) // 2  # number of triples incl. DC
        route = np.zeros((9 * n_modules, d))
        route[6:6 + 3 * k, :] = to_Fourier
        out_route = np.zeros((d, 9 * n_modules))
        out_route[:, 6:6 + 3 * k] = to_SSP

        vel_W = np.zeros((n_modules, 9, N))
        for j in range(1, n_oscs + 1):
            m = (j + 2) // 3
            slot = 3 * ((j + 2) % 3) + 2
            vel_W[m, slot, :] = ssp_space.phase_matrix[j, :]

        mask = np.ones(n_modules)
        mask[0] = 0.0

        with self:
            self.velocity_input = Node(size_in=N, label=f"{label}_vel_input")
            self.input = Node(size_in=d, label=f"{label}_input")
            self.output = Node(size_in=d, label=f"{label}_output")

            self.oscillators = EnsembleArray(
                n_neurons, n_modules, ens_dimensions=9, radius=np.sqrt(6),
                label=f"{label}_gc", **kwargs)

            Connection(self.input, self.oscillators.input, transform=route,
                       synapse=None)
            BatchedConnection(self.velocity_input, self.oscillators,
                              transforms=vel_W, synapse=recurrent_tau)
            self.recurrent = BatchedConnection(
                self.oscillators, self.oscillators, function=feedback,
                synapse=recurrent_tau, element_mask=mask,
                solver_weights=solver_weights)

            zerofreq = Node([0, 0, 0, 0, 0, 0, 1.0, 0, 0],
                            label=f"{label}_zerofreq")
            Connection(zerofreq, self.oscillators.ea_ensembles[0],
                       synapse=None)

            Connection(self.oscillators.output, self.output,
                       transform=out_route, synapse=None)


class PathIntegrationBCsGCs(Network):
    """VCO bank plus 6-D 'grid cell' populations computing cube-root
    phase-consistency error corrections fed back into oscillator pairs."""

    def __init__(self, ssp_space, n_neurons, n_gc_neurons, recurrent_tau,
                 scaling_factor=1, stable=True, max_radius=1, conn_scale=1,
                 error_correction_factor=0.1, label="pathint", **kwargs):
        super().__init__(label=label)
        d = ssp_space.ssp_dim
        N = ssp_space.domain_dim
        k = (d + 1) // 2

        base = vco_feedback(recurrent_tau, scaling_factor,
                            ssp_space.length_scale, max_radius, stable)

        def feedback(x):
            return conn_scale * np.asarray(base(x))

        ecf = error_correction_factor

        def _consistency(x):
            # product of the three oscillator phasors (phase-sum detector)
            er = (x[0] * x[2] * x[4] - x[0] * x[3] * x[5]
                  - x[1] * x[2] * x[5] - x[1] * x[3] * x[4])
            ei = (x[0] * x[2] * x[5] + x[0] * x[3] * x[4]
                  + x[1] * x[2] * x[4] - x[1] * x[3] * x[5])
            root = (er + 1j * ei) ** (1.0 / 3.0)
            return root.real, root.imag

        def combined_correction(x):
            # all three oscillator-pair corrections decoded from one 6-D
            # grid-cell population at once
            er, ei = _consistency(x)
            out = []
            for p in range(3):
                lo = 2 * p
                res = np.array([er * x[lo] + ei * x[lo + 1],
                                er * x[lo + 1] - ei * x[lo]])
                out.append(ecf * (res - x[lo:lo + 2]) + x[lo:lo + 2])
            return np.concatenate(out)

        to_SSP = get_from_Fourier(d)
        to_Fourier = get_to_Fourier(d)
        self.to_SSP = to_SSP
        self.to_Fourier = to_Fourier
        n_groups = (k) // 3

        with self:
            self.velocity_input = Node(size_in=N, label=f"{label}_vel_input")
            self.input = Node(size_in=d, label=f"{label}_input")
            self.output = Node(size_in=d, label=f"{label}_output")

            self.oscillators = EnsembleArray(
                n_neurons, k, ens_dimensions=3, radius=np.sqrt(2),
                label=f"{label}_vco", **kwargs)
            self.gridcells = EnsembleArray(
                n_gc_neurons, n_groups, ens_dimensions=6, radius=np.sqrt(2),
                label=f"{label}_gridcell")

            Connection(self.input, self.oscillators.input,
                       transform=to_Fourier, synapse=None)
            BatchedConnection(self.velocity_input, self.oscillators,
                              transforms=_velocity_transforms(
                                  ssp_space.phase_matrix, k),
                              synapse=None)
            mask = np.ones(k)
            mask[0] = 0.0
            BatchedConnection(self.oscillators, self.oscillators,
                              function=feedback, synapse=recurrent_tau,
                              element_mask=mask)

            zerofreq = Node([1.0, 0.0, 0.0], label=f"{label}_zerofreq")
            Connection(zerofreq, self.oscillators.ea_ensembles[0],
                       synapse=None)

            # oscillator (Re, Im) pairs -> grid-cell modules of 3: one
            # routed connection off the identity-decoded EA output
            R_in = np.zeros((6 * n_groups, 3 * k))
            for i in range(1, k):
                g = (i - 1) // 3
                if g >= n_groups:
                    break
                pos = 2 * ((i - 1) % 3)
                R_in[6 * g + pos, 3 * i] = 1.0
                R_in[6 * g + pos + 1, 3 * i + 1] = 1.0
            Connection(self.oscillators.output, self.gridcells.input,
                       transform=R_in, synapse=recurrent_tau)

            # phase-consistency corrections back into oscillator pairs: one
            # 6-D decoded output per module, routed into the oscillators the
            # module observes, 3g+1..3g+3
            corr_out = self.gridcells.add_output("corrections",
                                                 combined_correction,
                                                 out_dim=6)
            R_out = np.zeros((3 * k, 6 * n_groups))
            for g in range(n_groups):
                for p in range(3):
                    osc_index = 3 * g + 1 + p
                    if osc_index >= k:
                        break
                    R_out[3 * osc_index + 0, 6 * g + 2 * p] = 1.0
                    R_out[3 * osc_index + 1, 6 * g + 2 * p + 1] = 1.0
            Connection(corr_out, self.oscillators.input, transform=R_out,
                       synapse=recurrent_tau)

            Connection(self.oscillators.output, self.output,
                       transform=to_SSP, synapse=None)


# the reference's older copy of the network differs only in not keeping the
# recurrent-connection handles; the modern class covers both
PathIntegrationOld = PathIntegration
