"""Local-view-cell SLAM variant.

A port of :mod:`sspslam_tpu.models.slam_view`: a single ``view_input``
carries the superposition sum_i SP_i * phi(x_i - x) (precomputed,
normalised); the associative memory learns view -> cleaned
self-position-SSP directly (key = view vector, value = PI output after
clean-up); the correction gate is SLAMNetwork's, in either gate mode.  No
OVC or binding subnetworks are needed inside the model.  The clean-up and
the gates are the node functions of :mod:`.slam`, their tables hoisted
onto the Simulator's device.
"""

from __future__ import annotations

import numpy as np

from ..nef import Connection, Ensemble, Network, Node
from ..nef.distributions import CosineSimilarity
from ..nef.processes import TimeTable
from .associativememory import AssociativeMemory
from .pathintegration import PathIntegration
from .slam import (make_auto_recovery_gate_func, make_cleanup_fun,
                   make_update_state_func, _np_make_unitary, _vel_scale,
                   _wrap_cleanup_node)

__all__ = ["SLAMViewNetwork", "get_slamview_input_functions"]


class SLAMViewNetwork(Network):
    def __init__(self, ssp_space, lm_space, view_rad, n_landmarks,
                 pi_n_neurons, mem_n_neurons, circonv_n_neurons,
                 tau=0.01, tau_pi=0.05,
                 update_thres=0.2, vel_scaling_factor=1.0,
                 rad_scaling_factor=1.0, shift_rate=0.1,
                 voja_learning_rate=5e-4, pes_learning_rate=1e-2,
                 clean_up_method="grid", gc_n_neurons=0, encoders=None,
                 voja=True, seed=0, cleanup_samples_per_dim=100,
                 gate_mode="reference", gate_kwargs=None, anchor=False,
                 label="slamview"):
        super().__init__(label=label, seed=seed)

        domain_dim = ssp_space.domain_dim
        d = ssp_space.ssp_dim

        rng = np.random.RandomState(seed=seed)
        landmark_sps = lm_space.vectors
        if (not voja) and (encoders is None):
            encoders = landmark_sps[rng.randint(n_landmarks, size=mem_n_neurons), :]
        intercept = (landmark_sps @ landmark_sps.T - np.eye(n_landmarks)).max()

        # every clean-up method: grid / direct-optim / network /
        # network-optim / None, inside the step (models/slam.py)
        clean_up_fun, sample_ssps, sample_points = make_cleanup_fun(
            ssp_space, method=clean_up_method,
            samples_per_dim=cleanup_samples_per_dim)
        if sample_ssps is not None:
            self.sample_ssps = sample_ssps
            self.sample_points = sample_points
        self.clean_up_fun = clean_up_fun

        # gate shared with SLAMNetwork (thresholds hoisted: changed in
        # place without a recapture).  gate_mode='auto_recovery' carries
        # the in-model tracking-loss controller: the map-consistency
        # statistic cos(recall, value) transfers because value (recovered
        # as recall - err from the PES error population) is here the
        # CLEANED-PI self-position the memory learns directly — after a
        # kidnap the view recalls the TRUE location phi(x_true) while the value stream carries the wrong
        # phi(x_pi), near-orthogonal beyond the kernel width; during
        # initial learning PES drags recall colinear to value so the
        # statistic stays ~+1, exactly as in the landmark model.
        if gate_mode == "auto_recovery":
            gk = dict(gate_kwargs or {})
            if anchor:
                # the view family's internal statistics carry no kidnap
                # signature at all (continuous aliased view keys never
                # mismatch sharply), so detection
                # NEEDS the absolute beacon channels.  They transfer
                # unchanged from SLAMNetwork because the statistic
                # cos(pi (x) anchor_vec, anchor_pos) and the recovery
                # target ~anchor_vec (x) anchor_pos use only the PI pose
                # and the surveyed-beacon observation — nothing from the
                # view memory.
                gk.setdefault("anchor", True)
            update_state_func = make_auto_recovery_gate_func(
                update_thres, shift_rate, d, **gk)
            gate_in = (6 * d + 2) if anchor else (4 * d + 1)
            gate_out = d + 1
        elif gate_mode == "reference":
            if anchor:
                raise ValueError(
                    "anchor= requires gate_mode='auto_recovery' (the "
                    "reference gate has no detection channels to feed)")
            update_state_func = make_update_state_func(update_thres,
                                                       shift_rate, d)
            gate_in, gate_out = 2 * d + 1, d
        else:
            raise ValueError(f"gate_mode {gate_mode!r}: use 'reference' or "
                             "'auto_recovery'")

        with self:
            self.velocity_input = Node(size_in=domain_dim, label="vel_input")
            self.view_input = Node(size_in=d, label="lm_input")
            self.no_landmark_in_view = Node(size_in=1, label="lm_in_view_input")

            self.update_state = Node(update_state_func, size_in=gate_in,
                                     size_out=gate_out)
            Connection(self.no_landmark_in_view, self.update_state[-1],
                       synapse=None)

            self.pathintegrator = PathIntegration(
                ssp_space, pi_n_neurons, tau_pi,
                max_radius=rad_scaling_factor,
                scaling_factor=vel_scaling_factor, stable=True,
                label="pathint")
            self.output = self.pathintegrator.output
            Connection(self.velocity_input, self.pathintegrator.velocity_input,
                       synapse=None)
            corr_src = (self.update_state[:d]
                        if gate_mode == "auto_recovery" else
                        self.update_state)
            Connection(corr_src, self.pathintegrator.input,
                       synapse=None)

            # environment map: view vector -> self-position SSP
            self.assomemory = AssociativeMemory(
                mem_n_neurons, d, d, intercept,
                voja_learning_rate=voja_learning_rate,
                pes_learning_rate=pes_learning_rate,
                voja=voja, encoders=encoders)
            Connection(self.view_input, self.assomemory.key_input, synapse=None)
            Connection(self.no_landmark_in_view, self.assomemory.learning,
                       synapse=None)

            # clean-up of the PI output feeds the memory's value
            if clean_up_fun is None:
                self.gridcells = None
                Connection(self.pathintegrator.output,
                           self.assomemory.value_input, synapse=tau)
            elif gc_n_neurons <= 0:
                self.gridcells = Node(_wrap_cleanup_node(clean_up_fun),
                                      size_in=d, size_out=d, label="cleanup")
                Connection(self.pathintegrator.output, self.gridcells,
                           synapse=tau)
                Connection(self.gridcells, self.assomemory.value_input,
                           synapse=None)
            else:
                gc_encoders = ssp_space.sample_grid_encoders(gc_n_neurons)
                self.cleanup = Node(_wrap_cleanup_node(clean_up_fun),
                                    size_in=d, size_out=d, label="cleanup")
                self.gridcells = Ensemble(
                    gc_n_neurons, d, encoders=gc_encoders,
                    intercepts=CosineSimilarity(d + 2), label="gridcells")
                Connection(self.pathintegrator.output, self.cleanup, synapse=tau)
                Connection(self.cleanup, self.gridcells, synapse=None)
                Connection(self.gridcells, self.assomemory.value_input,
                           synapse=tau)

            # gated correction using the recalled position directly.
            # Auto-recovery evidence rides a slower dedicated synapse, the
            # same rule as SLAMNetwork (the controller's loss statistics
            # were validated on 50 ms-filtered signals; per-step decodes
            # are ~5x noisier and false-trigger right after arming)
            ev_tau = max(tau, 0.05) if gate_mode == "auto_recovery" else tau
            Connection(self.assomemory.recall, self.update_state[:d],
                       function=_np_make_unitary, synapse=ev_tau)
            Connection(self.pathintegrator.output,
                       self.update_state[d:2 * d], synapse=ev_tau)
            if gate_mode == "auto_recovery":
                # raw recall magnitude = view-familiarity evidence; the
                # PES error output lets the gate reconstruct value =
                # recall - err for the consistency statistic.  The
                # suppress channel freezes map learning during recovery
                # with the correct signs (see SLAMNetwork.__init__):
                # -2.5/neuron into the error population (PES freeze) and
                # -0.1 into the Voja rule so its 1 + gate signal cancels.
                Connection(self.assomemory.recall,
                           self.update_state[2 * d:3 * d], synapse=ev_tau)
                Connection(self.assomemory.error,
                           self.update_state[3 * d:4 * d], synapse=ev_tau)
                if anchor:
                    # surveyed-beacon observation stream, identical wiring
                    # to SLAMNetwork (see get_anchor_input_functions)
                    self.anchor_pos_input = Node(size_in=d,
                                                 label="anchor_pos_input")
                    self.anchor_vec_ssp = Node(size_in=d,
                                               label="anchor_vecssp_input")
                    self.no_anchor_in_view = Node(
                        size_in=1, label="anchor_in_view_input")
                    Connection(self.anchor_pos_input,
                               self.update_state[4 * d:5 * d], synapse=None)
                    Connection(self.anchor_vec_ssp,
                               self.update_state[5 * d:6 * d], synapse=None)
                    Connection(self.no_anchor_in_view,
                               self.update_state[6 * d], synapse=None)
                Connection(self.update_state[d],
                           self.assomemory.error.neurons,
                           transform=-2.5 * np.ones((mem_n_neurons, 1)),
                           synapse=None)
                if voja:
                    Connection(self.update_state[d],
                               self.assomemory.conn_in.learning_rule,
                               transform=-0.1, synapse=None)


def get_slamview_input_functions(ssp_space, lm_space, velocity_data,
                                 vec_to_landmarks_data, view_rad, dt=0.001):
    """Adapters for SLAMViewNetwork: the view signal is the normalised
    superposition of SP_i bound with the SSP of the egocentric vector to
    each in-view landmark.

    Returns (velocity_func, vel_scaling_factor, is_landmark_in_view,
    landmark_func)."""
    landmark_sps = lm_space.vectors

    real_freqs = ssp_space.phase_matrix @ velocity_data.T
    vel_scaling_factor = _vel_scale(np.max(np.abs(real_freqs)))
    vels_scaled = velocity_data * vel_scaling_factor

    dists = np.linalg.norm(vec_to_landmarks_data, axis=2)  # (T, L)
    mask = dists < view_rad
    any_in_view = mask.any(axis=1)

    # bound view per timestep: sum_l mask_tl SP_l (*) phi(x_l - x_t).
    # FPE additivity (phi(a - b) = phi(a) (*) phi(-b), exact) factors this as
    #   phi(x_0 - x_t) (*) sum_l mask_tl [SP_l (*) phi(x_l - x_0)]
    # (x_0 = position at t=0): the landmark constants bind ONCE, and the
    # per-timestep work is one masked matmul + one row-wise bind + one
    # encode — instead of T*L encodes and L full-length binds.
    # Algebraically identical to a per-landmark loop.
    C = np.asarray(ssp_space.bind(
        landmark_sps,
        np.asarray(ssp_space.encode(vec_to_landmarks_data[0]))))   # (L, d)
    neg_y = (vec_to_landmarks_data[:, 0, :]
             - vec_to_landmarks_data[0, 0, :])                     # x_0 - x_t
    phi_neg = np.asarray(ssp_space.encode(neg_y))                  # (T, d)
    s = mask.astype(np.float64) @ C                                # (T, d)
    views = np.asarray(ssp_space.bind(phi_neg, s))
    norms = np.linalg.norm(views, axis=1, keepdims=True)
    views = np.where(norms > 1e-8, views / np.maximum(norms, 1e-8), views)

    velocity_func = TimeTable(vels_scaled, dt)
    landmark_func = TimeTable(views, dt)
    is_landmark_in_view = TimeTable(np.where(any_in_view, 0.0, 1.0), dt)
    return velocity_func, vel_scaling_factor, is_landmark_in_view, landmark_func
