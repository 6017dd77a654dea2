"""SSP-SLAM: path integration + associative map + landmark loop closure.

Port of :mod:`sspslam_tpu.models.slam`: ``SLAMNetwork``, its node
functions (the four clean-ups, the reference correction gate and the
auto-recovery gate with its anchor channels) and the data adapters, with
the same public names.  The node functions are torch closures the step
runs; they never synchronise with the host, so the Simulator captures the
whole SLAM step as a CUDA graph.

Every table a node function reads (the clean-up's sample bank, the gates'
thresholds and rates) is carried as ``hoisted_consts``: the builder puts it
in the parameter tree and ``build_params`` places it on the Simulator's
device, so the network is built before any device is named, and a
threshold changed in place (``sim.params["hoisted"][key]["shift_rate"]``)
takes effect at the next step or graph replay.  (The JAX package offers
this as an option, ``SSPSLAM_HOIST_*``, for the TPU's on-chip memory; in
the port it is the only layout.)

The grid clean-up and both gates carry ``np_function``: a NumPy mirror the
host interpreter (:class:`nef.reference_backend.NumpyStepper`) calls in
place of the torch function, with the same hoisted ``consts``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nef import Connection, Ensemble, Network, Node, ScatteredHypersphere
from ..nef.distributions import CosineSimilarity
from ..nef.processes import TimeTable
from ..ops import vsa
from ..sspspace import _mlp_apply, _newton_refine_core
from .associativememory import AssociativeMemory
from .binding import CircularConvolution
from .pathintegration import PathIntegration

__all__ = ["SLAMNetwork", "get_slam_input_functions",
           "get_anchor_input_functions",
           "get_slam_input_functions2", "make_cleanup_fun",
           "make_update_state_func", "make_auto_recovery_gate_func"]


def _consts_on(hoisted: dict, device) -> dict:
    """A node's hoisted tables as tensors on ``device``, for a call made
    outside the step (the step passes its own, already there)."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in hoisted.items()}


def make_cleanup_fun(ssp_space, method="grid", samples_per_dim=100,
                     sim_dtype=None, newton_iters=8):
    """Return ``(cleanup_fun, sample_ssps, sample_points)``: the clean-up
    of the PI output inside the step.

    - ``'grid'``: the argmax of the similarity against a sample bank of
      ``samples_per_dim`` points per axis, the row gathered from the
      float32 bank.
    - ``'direct-optim'``: the grid argmax's point as the start, then
      ``newton_iters`` damped-Newton steps on the Fourier-domain
      similarity (:func:`sspspace._newton_refine_core`), then phi(x*).
    - ``'network'``: the trained MLP decoder's point, re-encoded (an
      untrained space is trained first: ``train_decoder_net()`` on its
      default device, the card).
    - ``'network-optim'``: the MLP's point as the start, then the Newton
      polish.
    - ``None``: no clean-up (returns three Nones).

    ``sim_dtype`` is the grid similarity product's dtype (default
    :func:`vsa.default_cleanup_dtype`: bfloat16 unless
    SSPSLAM_CLEANUP_F32=1).  Every table the function reads is in
    ``cleanup_fun.hoisted_consts`` (``bank`` float32 and ``bank_sim`` in
    ``sim_dtype``, so a bf16 bank is not cast every step; the grid's
    ``points``; the Newton polish's ``mat`` = phase / length scale, the
    DFT tables ``C_mat`` / ``S_mat`` and the bounds ``lo`` / ``hi``; the
    MLP's ``mlp0``-``mlp5``; ``phase`` and ``ls`` for the re-encode):
    ``cleanup_fun(x, consts)`` reads them from ``consts``, and called
    without them it copies its own to ``x``'s device.  ``x`` is (..., d).
    """
    if method is None:
        return None, None, None
    if method not in ("grid", "direct-optim", "network", "network-optim"):
        raise ValueError(
            f"clean_up_method {method!r}: use 'grid', 'direct-optim', "
            "'network', 'network-optim' or None")

    sdt = vsa.default_cleanup_dtype() if sim_dtype is None else sim_dtype
    n = ssp_space.domain_dim
    hoisted = {}
    sample_ssps = sample_points = None
    if method in ("grid", "direct-optim"):
        sample_ssps, sample_points = ssp_space.get_sample_pts_and_ssps(
            samples_per_dim)
        bank = torch.as_tensor(np.asarray(sample_ssps, np.float32))
        if method == "grid":
            hoisted["bank"] = bank.numpy()
        else:
            hoisted["points"] = np.asarray(sample_points, np.float32)
        hoisted["bank_sim"] = bank.to(sdt)
    if method in ("network", "network-optim"):
        if ssp_space.decoder_params is None:
            ssp_space.train_decoder_net()
        for i, p in enumerate(ssp_space.decoder_params):
            hoisted[f"mlp{i}"] = np.array(p, np.float32)
    if method != "grid":
        hoisted["phase"] = np.asarray(ssp_space.phase_matrix, np.float32)
        hoisted["ls"] = np.asarray(ssp_space.length_scale,
                                   np.float32).ravel()
    if method in ("direct-optim", "network-optim"):
        d = ssp_space.ssp_dim
        hoisted["mat"] = np.asarray(
            ssp_space.phase_matrix
            / np.asarray(ssp_space.length_scale).reshape(1, -1), np.float32)
        # DFT tables for the target spectrum conj(F(v)) in real
        # arithmetic: F = C v - i S v, conj(F) = C v + i S v
        jk = 2 * np.pi * np.outer(np.arange(d), np.arange(d)) / d
        hoisted["C_mat"] = np.cos(jk).astype(np.float32)
        hoisted["S_mat"] = np.sin(jk).astype(np.float32)
        if ssp_space.domain_bounds is not None:
            hoisted["lo"] = ssp_space.domain_bounds[:, 0].astype(np.float32)
            hoisted["hi"] = ssp_space.domain_bounds[:, 1].astype(np.float32)

    def grid_point(x, c):
        best = torch.argmax(vsa.similarity(c["bank_sim"],
                                           x.to(c["bank_sim"].dtype)), dim=-1)
        return c["points"].index_select(0, best.reshape(-1)).reshape(
            x.shape[:-1] + (n,))

    def mlp_point(x, c):
        return _mlp_apply([c[f"mlp{i}"] for i in range(6)], x)

    def newton_polish(x, x0, c):
        u = vsa.make_unitary(x)
        lo_hi = (c["lo"], c["hi"]) if "lo" in c else None
        pt = _newton_refine_core(c["mat"], u @ c["C_mat"].T,
                                 u @ c["S_mat"].T, x0, lo_hi, newton_iters)
        return vsa.encode(c["phase"], pt, c["ls"])

    def cleanup_fun(x, consts=None):
        c = _consts_on(hoisted, x.device) if consts is None else consts
        if method == "grid":
            return vsa.nearest_row(c["bank"], c["bank_sim"], x)
        if method == "direct-optim":
            return newton_polish(x, grid_point(x, c), c)
        if method == "network":
            return vsa.encode(c["phase"], mlp_point(x, c), c["ls"])
        return newton_polish(x, mlp_point(x, c), c)

    cleanup_fun.hoisted_consts = hoisted
    if method == "grid":
        # a sharded step holds these as row shards (vsa.nearest_row)
        cleanup_fun.row_sharded = ("bank", "bank_sim")
        def _cleanup_np(x, consts=None):
            # the host interpreter's mirror: one float32 matvec and argmax
            b = np.asarray((hoisted if consts is None else consts)["bank"],
                           np.float32)
            return b[int(np.argmax(b @ np.asarray(x, np.float32)))]
        cleanup_fun.np_function = _cleanup_np
    return cleanup_fun, sample_ssps, sample_points


def make_update_state_func(update_thres, shift_rate, d):
    """The loop-closure correction gate (the JAX package's reference gate):
    ``shift_rate * (estimate - PI)`` when a landmark is in view AND the
    estimate agrees with the PI output above ``update_thres``, else 0.
    Input ``[pos_est(d), pi_est(d), no_view(1)]``; the two thresholds are
    hoisted (``consts``)."""
    hoisted = {"update_thres": np.float32(update_thres),
               "shift_rate": np.float32(shift_rate)}

    def update_state_func(t, x, consts=None):
        if consts is None:
            consts = _consts_on(hoisted, x.device)
        pos_est, pi_est = x[:d], x[d:2 * d]
        ok = (x[-1].abs() < 1e-3) & (
            torch.sum(pos_est * pi_est) > consts["update_thres"])
        return torch.where(ok, consts["shift_rate"] * (pos_est - pi_est),
                           0.0)

    update_state_func.hoisted_consts = hoisted

    def _update_state_np(t, x, consts=None):
        c = hoisted if consts is None else consts
        pos_est, pi_est = x[:d], x[d:2 * d]
        if (abs(float(x[-1])) < 1e-3
                and float(pos_est @ pi_est) > float(c["update_thres"])):
            return float(c["shift_rate"]) * (pos_est - pi_est)
        return np.zeros(d, np.float32)
    update_state_func.np_function = _update_state_np
    return update_state_func


def make_auto_recovery_gate_func(update_thres, shift_rate, d, dt=0.001,
                                 recovery_shift_rate=0.3, trigger=0.2,
                                 exit_thres=0.6, familiar=0.25,
                                 ema_tau=0.5, recovery_T=25.0,
                                 arm_at_start=False, cons_trigger=0.5,
                                 cons_ema_tau=0.25, recovery_decay=True,
                                 anchor=False, anchor_trigger=0.2):
    """The self-healing correction gate, a stateful node (the JAX package's
    ``make_auto_recovery_gate_func``; its docstring gives the rules and the
    measurements behind them).

    State ``[armed, agreement_ema, recovery_timer, cons_ema]`` (+
    ``anchor_ema`` with ``anchor``).  It arms once the smoothed agreement
    cos(estimate, PI) reaches ``exit_thres``; while armed it triggers a
    ``recovery_T``-second recovery when, on a familiar landmark in view,
    the agreement EMA falls under ``trigger`` or the map-consistency EMA
    cos(recall, recall - err) under ``cons_trigger`` (or, with ``anchor``,
    the absolute agreement cos(pi (x) anchor_vec, anchor_pos) on a surveyed
    landmark under ``anchor_trigger``).  During recovery corrections always
    apply, at ``recovery_shift_rate`` (decaying linearly to ``shift_rate``
    over the window with ``recovery_decay``), toward ``~anchor_vec (x)
    anchor_pos`` while a surveyed landmark is in view, and the ``suppress``
    output (10) freezes map learning.

    Input ``[pos(d), pi(d), recall(d), err(d), no_view(1)]``, or with
    ``anchor`` ``[pos, pi, recall, err, anchor_pos(d), anchor_vec(d),
    anchor_no_view(1), no_view(1)]``; output ``[correction(d),
    suppress(1)]``.  All thresholds and rates are hoisted."""
    alpha = float(dt / ema_tau)
    alpha_c = float(dt / cons_ema_tau)
    R = float(recovery_T / dt)
    has_anchor = bool(anchor)

    def cos(a, b):
        return torch.sum(a * b) / (torch.linalg.vector_norm(a)
                                   * torch.linalg.vector_norm(b) + 1e-9)

    def gate(t, x, s, consts):
        thr = consts["update_thres"]
        sr = consts["shift_rate"]
        rsr = consts["recovery_shift_rate"]
        pos_est, pi_est = x[:d], x[d:2 * d]
        recall, err = x[2 * d:3 * d], x[3 * d:4 * d]
        in_view = x[-1].abs() < 1e-3
        dot = torch.sum(pos_est * pi_est)
        agree = dot / (torch.linalg.vector_norm(pos_est)
                       * torch.linalg.vector_norm(pi_est) + 1e-9)
        conclusive = in_view & (torch.linalg.vector_norm(recall)
                                >= consts["familiar"])
        ema = torch.where(conclusive, (1 - alpha) * s[1] + alpha * agree,
                          s[1])
        # the map-consistency evidence holds across inconclusive steps
        # (out of view / unfamiliar)
        cons_ema = torch.where(
            conclusive, (1 - alpha_c) * s[3] + alpha_c * cos(recall,
                                                             recall - err),
            s[3])
        armed = torch.maximum(s[0],
                              (ema >= consts["exit_thres"]).to(torch.float32))
        timer = torch.clamp_min(s[2] - 1.0, 0.0)
        lost = (((ema < consts["trigger"])
                 | (cons_ema < consts["cons_trigger"])) & conclusive)
        if has_anchor:
            anc_pos, anc_vec = x[4 * d:5 * d], x[5 * d:6 * d]
            anchor_seen = x[-2].abs() < 1e-3
            a_agree = cos(vsa.bind(pi_est, anc_vec), anc_pos)
            a_ema = torch.where(anchor_seen,
                                (1 - alpha_c) * s[4] + alpha_c * a_agree,
                                s[4])
            lost = lost | ((a_ema < consts["anchor_trigger"]) & anchor_seen)
        trigger_now = (armed > 0) & lost & (timer <= 0)
        timer = torch.where(trigger_now, R, timer)
        in_rec = timer > 0
        # entering recovery resets the consistency evidence
        cons_ema = torch.where(trigger_now, 1.0, cons_ema)
        gate_ok = in_view & ((dot > thr) | in_rec)
        rsr_eff = (sr + (rsr - sr) * timer / R) if recovery_decay else rsr
        target = pos_est - pi_est
        if has_anchor:
            a_ema = torch.where(trigger_now, 1.0, a_ema)
            target = torch.where(in_rec & anchor_seen,
                                 vsa.unbind(anc_vec, anc_pos) - pi_est,
                                 target)
        corr = torch.where(gate_ok, torch.where(in_rec, rsr_eff, sr) * target,
                           0.0)
        suppress = 10.0 * in_rec.to(torch.float32)
        state = [armed, ema, timer, cons_ema] + ([a_ema] if has_anchor
                                                 else [])
        return torch.cat([corr, suppress.reshape(1)]), torch.stack(state)

    # trusted-map / localization mode starts armed
    gate.state_init = np.array(
        [1.0 if arm_at_start else 0.0, 0.0, 0.0, 1.0]
        + ([1.0] if has_anchor else []), np.float32)
    gate.hoisted_consts = {
        "update_thres": np.float32(update_thres),
        "shift_rate": np.float32(shift_rate),
        "recovery_shift_rate": np.float32(recovery_shift_rate),
        "trigger": np.float32(trigger),
        "exit_thres": np.float32(exit_thres),
        "familiar": np.float32(familiar),
        "cons_trigger": np.float32(cons_trigger),
    }
    if has_anchor:
        gate.hoisted_consts["anchor_trigger"] = np.float32(anchor_trigger)

    def _gate_np(t, x, s, consts):
        # the host interpreter's mirror of ``gate``, branch by branch
        thr, sr = float(consts["update_thres"]), float(consts["shift_rate"])
        rsr = float(consts["recovery_shift_rate"])
        pos_est, pi_est = x[:d], x[d:2 * d]
        recall, err = x[2 * d:3 * d], x[3 * d:4 * d]
        in_view = abs(float(x[-1])) < 1e-3
        dot = float(pos_est @ pi_est)
        agree = dot / (np.linalg.norm(pos_est)
                       * np.linalg.norm(pi_est) + 1e-9)
        conclusive = (in_view
                      and np.linalg.norm(recall) >= float(consts["familiar"]))
        armed, ema, timer, cons_ema = (float(s[0]), float(s[1]),
                                       float(s[2]), float(s[3]))
        if conclusive:
            ema = (1 - alpha) * ema + alpha * agree
            value = recall - err
            cons = float(recall @ value) / float(
                np.linalg.norm(recall) * np.linalg.norm(value) + 1e-9)
            cons_ema = (1 - alpha_c) * cons_ema + alpha_c * cons
        armed = max(armed, float(ema >= float(consts["exit_thres"])))
        timer = max(timer - 1.0, 0.0)
        lost = ((ema < float(consts["trigger"])
                 or cons_ema < float(consts["cons_trigger"]))
                and conclusive)
        anchor_seen = False
        a_ema = float(s[4]) if has_anchor else 1.0
        if has_anchor:
            anc_pos, anc_vec = x[4 * d:5 * d], x[5 * d:6 * d]
            anchor_seen = abs(float(x[-2])) < 1e-3
            if anchor_seen:
                bound = np.fft.ifft(np.fft.fft(pi_est)
                                    * np.fft.fft(anc_vec)).real
                a_agree = float(bound @ anc_pos) / float(
                    np.linalg.norm(bound) * np.linalg.norm(anc_pos) + 1e-9)
                a_ema = (1 - alpha_c) * a_ema + alpha_c * a_agree
                lost = lost or a_ema < float(consts["anchor_trigger"])
        if armed > 0 and lost and timer <= 0:
            timer = R
            cons_ema = 1.0
            a_ema = 1.0
        in_rec = timer > 0
        out = np.zeros(d + 1, np.float32)
        rsr_eff = (sr + (rsr - sr) * timer / R) if recovery_decay else rsr
        if in_view and (dot > thr or in_rec):
            target = pos_est - pi_est
            if has_anchor and in_rec and anchor_seen:
                pose_abs = np.fft.ifft(np.conj(np.fft.fft(anc_vec))
                                       * np.fft.fft(anc_pos)).real
                target = pose_abs - pi_est
            out[:d] = (rsr_eff if in_rec else sr) * target
        out[d] = 10.0 if in_rec else 0.0
        state = [armed, ema, timer, cons_ema] + ([a_ema] if has_anchor
                                                 else [])
        return out, np.array(state, np.float32)

    gate.np_function = _gate_np
    return gate


def _wrap_cleanup_node(clean_up_fun):
    """A clean-up callable as a ``(t, x, consts)`` node function carrying
    its ``hoisted_consts`` and, where it has one, its NumPy mirror."""
    def cleanup_node_fn(t, x, consts=None, _f=clean_up_fun):
        return _f(x, consts)
    cleanup_node_fn.hoisted_consts = clean_up_fun.hoisted_consts
    if hasattr(clean_up_fun, "row_sharded"):
        cleanup_node_fn.row_sharded = clean_up_fun.row_sharded
    npf = getattr(clean_up_fun, "np_function", None)
    if npf is not None:
        cleanup_node_fn.np_function = (
            lambda t, x, consts=None, _f=npf: _f(x, consts))
    return cleanup_node_fn


class SLAMNetwork(Network):
    """Full SSP-SLAM network.

    Required inputs: ``velocity_input`` (domain_dim), ``landmark_vec_ssp``
    (d), ``landmark_id_input`` (d; the landmark SP), ``no_landmark_in_view``
    (1; 0 when a landmark is visible, large otherwise); with
    ``gate_mode="auto_recovery", anchor=True`` also ``anchor_pos_input``,
    ``anchor_vec_ssp`` and ``no_anchor_in_view``.
    Output: ``output`` — the path integrator's SSP self-position estimate.
    """

    def __init__(self, ssp_space, lm_space, view_rad, n_landmarks,
                 pi_n_neurons, mem_n_neurons, circonv_n_neurons,
                 tau=0.01, tau_pi=0.05,
                 update_thres=0.2, vel_scaling_factor=1.0,
                 rad_scaling_factor=1.0, shift_rate=0.1,
                 voja_learning_rate=5e-4, pes_learning_rate=1e-2,
                 clean_up_method="grid", gc_n_neurons=0, encoders=None,
                 voja=True, seed=0, landmark_sps=None, intercept=None,
                 cleanup_samples_per_dim=100, gate_mode="reference",
                 gate_kwargs=None, anchor=False, label="slam"):
        super().__init__(label=label, seed=seed)

        domain_dim = ssp_space.domain_dim
        d = ssp_space.ssp_dim

        rng = np.random.RandomState(seed=seed)
        if landmark_sps is None:
            landmark_sps = lm_space.vectors
        if (not voja) and (encoders is None):
            encoders = landmark_sps[
                rng.randint(n_landmarks, size=mem_n_neurons), :]
        if intercept is None:
            intercept = min(
                (landmark_sps @ landmark_sps.T - np.eye(n_landmarks)).max(),
                0.5)

        # object-vector-cell encoders: SSPs of scattered displacement vectors
        ovc_n_neurons = mem_n_neurons
        ovc_vectors = ScatteredHypersphere(
            surface=False, min_magnitude=1e-3).sample(
            ovc_n_neurons, domain_dim, rng=np.random.default_rng(seed))
        OVC_encoders = ssp_space.encode(ovc_vectors)

        clean_up_fun, sample_ssps, sample_points = make_cleanup_fun(
            ssp_space, method=clean_up_method,
            samples_per_dim=cleanup_samples_per_dim)
        if sample_ssps is not None:
            self.sample_ssps = sample_ssps
            self.sample_points = sample_points
        self.clean_up_fun = clean_up_fun

        if gate_mode == "auto_recovery":
            gk = dict(gate_kwargs or {})
            if anchor:
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
            update_state_func = make_update_state_func(
                update_thres, shift_rate, d)
            gate_in, gate_out = 2 * d + 1, d
        else:
            raise ValueError(f"gate_mode {gate_mode!r}: use 'reference' or "
                             "'auto_recovery'")

        with self:
            self.velocity_input = Node(size_in=domain_dim, label="vel_input")
            self.landmark_id_input = Node(size_in=d, label="lm_id_input")
            self.landmark_vec_ssp = Node(size_in=d, label="lm_vecssp_input")
            self.no_landmark_in_view = Node(size_in=1,
                                            label="lm_in_view_input")

            self.update_state = Node(update_state_func, size_in=gate_in,
                                     size_out=gate_out)
            Connection(self.no_landmark_in_view, self.update_state[-1],
                       synapse=None)

            # path integrator
            self.pathintegrator = PathIntegration(
                ssp_space, pi_n_neurons, tau_pi,
                max_radius=rad_scaling_factor,
                scaling_factor=vel_scaling_factor, stable=True,
                label="pathint")
            self.output = self.pathintegrator.output
            Connection(self.velocity_input,
                       self.pathintegrator.velocity_input, synapse=None)
            corr_src = (self.update_state[:d]
                        if gate_mode == "auto_recovery" else
                        self.update_state)
            Connection(corr_src, self.pathintegrator.input, synapse=None)

            # object vector cells
            self.ovc_ens = Ensemble(ovc_n_neurons, d, encoders=OVC_encoders,
                                    label="ovc")
            Connection(self.landmark_vec_ssp, self.ovc_ens, synapse=None)

            # bind cleaned self-position with the egocentric landmark SSP
            self.landmark_ssp_ens = CircularConvolution(
                circonv_n_neurons, dimensions=d, label="landmark_circonv")
            Connection(self.ovc_ens, self.landmark_ssp_ens.input_b,
                       synapse=None)

            # clean-up of the PI output
            if clean_up_fun is None:
                self.gridcells = None
                Connection(self.pathintegrator.output,
                           self.landmark_ssp_ens.input_a, synapse=tau)
            elif gc_n_neurons <= 0:
                self.gridcells = Node(_wrap_cleanup_node(clean_up_fun),
                                      size_in=d, size_out=d, label="cleanup")
                Connection(self.pathintegrator.output, self.gridcells,
                           synapse=tau)
                Connection(self.gridcells, self.landmark_ssp_ens.input_a,
                           synapse=None)
            else:
                gc_encoders = ssp_space.sample_grid_encoders(gc_n_neurons)
                self.cleanup = Node(_wrap_cleanup_node(clean_up_fun),
                                    size_in=d, size_out=d, label="cleanup")
                self.gridcells = Ensemble(
                    gc_n_neurons, d, encoders=gc_encoders,
                    intercepts=CosineSimilarity(d + 2), label="gridcells")
                Connection(self.pathintegrator.output, self.cleanup,
                           synapse=tau)
                Connection(self.cleanup, self.gridcells, synapse=None)
                Connection(self.gridcells, self.landmark_ssp_ens.input_a,
                           synapse=tau)

            # environment map
            self.assomemory = AssociativeMemory(
                mem_n_neurons, d, d, intercept,
                voja_learning_rate=voja_learning_rate,
                pes_learning_rate=pes_learning_rate,
                voja=voja, encoders=encoders)
            Connection(self.landmark_id_input, self.assomemory.key_input,
                       synapse=None)
            Connection(self.landmark_ssp_ens.output,
                       self.assomemory.value_input, synapse=tau)
            Connection(self.no_landmark_in_view, self.assomemory.learning,
                       synapse=None)

            # position estimate: unbind recalled landmark SSP by the OVC
            # vector
            self.position_estimate = CircularConvolution(
                circonv_n_neurons, d, invert_a=True, label="newpos_circonv")
            Connection(self.ovc_ens, self.position_estimate.input_a,
                       synapse=tau, function=_np_make_unitary)
            Connection(self.assomemory.recall,
                       self.position_estimate.input_b,
                       synapse=tau, function=_np_make_unitary)

            # gated correction into the path integrator.  The auto gate's
            # loss statistics were validated against 50 ms-filtered
            # signals, so it reads them through a dedicated evidence
            # synapse (the JAX package's SLAMNetwork gives the measurements)
            ev_tau = max(tau, 0.05) if gate_mode == "auto_recovery" else tau
            Connection(self.position_estimate.output, self.update_state[:d],
                       synapse=ev_tau)
            Connection(self.pathintegrator.output,
                       self.update_state[d:2 * d], synapse=ev_tau)
            if gate_mode == "auto_recovery":
                # raw recall magnitude is the familiarity evidence, the PES
                # error population (recall - value) the map-consistency
                # channel
                Connection(self.assomemory.recall,
                           self.update_state[2 * d:3 * d], synapse=ev_tau)
                Connection(self.assomemory.error,
                           self.update_state[3 * d:4 * d], synapse=ev_tau)
                if anchor:
                    # beacon observations: ground-truth tables from the
                    # perception adapter (get_anchor_input_functions)
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
                # the suppress channel freezes map learning: -2.5 per neuron
                # into the PES error population and -0.1 into the Voja rule,
                # whose 1 + gate signal then cancels to 0 (it must not ride
                # the ``learning`` node, which would speed Voja up)
                Connection(self.update_state[d],
                           self.assomemory.error.neurons,
                           transform=-2.5 * np.ones((mem_n_neurons, 1)),
                           synapse=None)
                if voja:
                    Connection(self.update_state[d],
                               self.assomemory.conn_in.learning_rule,
                               transform=-0.1, synapse=None)


def _vel_scale(max_abs_freq) -> float:
    """1/max|A v| velocity normalisation, with a stationary world (all-zero
    velocity) given scale 1 instead of inf."""
    m = float(max_abs_freq)
    return 1.0 / m if np.isfinite(m) and m > 0 else 1.0


def _np_make_unitary(x):
    """NumPy make-unitary for decoder solving (vectorised over rows)."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    fx = np.fft.fft(x, axis=-1)
    fx = fx / np.maximum(np.abs(fx), 1e-8)
    out = np.fft.ifft(fx, axis=-1).real
    return out if out.shape[0] > 1 else out[0]


# ---------------------------------------------------------------------------
# Data -> input-signal adapters (host NumPy; they return TimeTables)
# ---------------------------------------------------------------------------

def _step_of(t, dt, pathlen):
    return min(max(int(round((t - dt) / dt)), 0), pathlen - 1)


def get_slam_input_functions(ssp_space, lm_space, velocity_data,
                             vec_to_landmarks_data, view_rad, dt=0.001):
    """Recorded trajectory / landmark data as input signals, the single
    nearest landmark in view.

    Returns (velocity_func, vel_scaling_factor, is_landmark_in_view,
    landmark_id_func, landmark_sp_func, landmark_vec_func,
    landmark_vecssp_func): TimeTables, except ``landmark_id_func(t)``."""
    pathlen = vec_to_landmarks_data.shape[0]
    landmark_sps = lm_space.vectors

    vel_scaling_factor = _vel_scale(np.max(
        np.abs(ssp_space.phase_matrix @ velocity_data.T)))
    vels_scaled = velocity_data * vel_scaling_factor

    # nearest-in-view landmark per timestep
    dists = np.linalg.norm(vec_to_landmarks_data, axis=2)  # (T, L)
    nearest = np.argmin(dists, axis=1)
    in_view = dists[np.arange(pathlen), nearest] <= view_rad
    lm_ids = np.where(in_view, nearest, -1)

    vec_rows = vec_to_landmarks_data[np.arange(pathlen), nearest, :]
    vec_ssp_rows = np.asarray(ssp_space.encode(vec_rows))

    seen = in_view[:, None]
    velocity_func = TimeTable(vels_scaled, dt)
    landmark_vec_func = TimeTable(np.where(seen, vec_rows, 0.0), dt)
    landmark_sp_func = TimeTable(
        np.where(seen, landmark_sps[np.maximum(lm_ids, 0)], 0.0), dt)
    landmark_vecssp_func = TimeTable(np.where(seen, vec_ssp_rows, 0.0), dt)
    is_landmark_in_view = TimeTable(np.where(in_view, 0.0, 10.0), dt)

    def landmark_id_func(t):
        return lm_ids[_step_of(t, dt, pathlen)]

    return (velocity_func, vel_scaling_factor, is_landmark_in_view,
            landmark_id_func, landmark_sp_func, landmark_vec_func,
            landmark_vecssp_func)


def get_slam_input_functions2(ssp_space, lm_space, velocity_data,
                              vec_to_landmarks_data, view_rad, dt=0.001):
    """Multi-landmark version: superimposes the SPs / vec-SSPs of all
    landmarks within the view radius."""
    pathlen, n_landmarks, domain_dim = vec_to_landmarks_data.shape
    d = ssp_space.ssp_dim
    landmark_sps = lm_space.vectors

    vel_scaling_factor = _vel_scale(np.max(
        np.abs(ssp_space.phase_matrix @ velocity_data.T)))
    vels_scaled = velocity_data * vel_scaling_factor

    dists = np.linalg.norm(vec_to_landmarks_data, axis=2)  # (T, L)
    mask = dists <= view_rad                               # (T, L)
    any_in_view = mask.any(axis=1)

    sum_vecs = np.einsum("tl,tln->tn", mask, vec_to_landmarks_data)
    sum_sps = mask.astype(np.float64) @ landmark_sps        # (T, d)
    # The masked superposition of the in-view vector SSPs, factorised by
    # phi(a + b) = phi(a) (*) phi(b):
    #   sum_l m_tl phi(x_l - x_t) = phi(x_0 - x_t) (*) [m_t @ phi(x_l - x_0)]
    # L + T encodes instead of T * L.  Exact only for rigid data (every
    # landmark's displacement moves with the agent alone), so that is
    # checked on sampled steps, and non-rigid data takes the exact
    # per-point encode.
    probe_t = np.unique(np.linspace(0, pathlen - 1, 8).astype(int))
    delta = vec_to_landmarks_data[probe_t] - vec_to_landmarks_data[0]
    rigid = np.allclose(delta, delta[:, :1, :], atol=1e-6)
    if rigid:
        base_ssps = np.asarray(ssp_space.encode(
            vec_to_landmarks_data[0]))                      # (L, d)
        shift = np.asarray(ssp_space.encode(
            vec_to_landmarks_data[:, 0, :]
            - vec_to_landmarks_data[0, 0, :]))              # (T, d)
        masked_base = mask @ base_ssps                      # (T, d)
        sum_vec_ssps = np.fft.ifft(
            np.fft.fft(shift, axis=1) * np.fft.fft(masked_base, axis=1),
            axis=1).real
    else:
        # exact path, chunked over time to bound the (chunk*L, d) encode
        sum_vec_ssps = np.empty((pathlen, d))
        chunk = max(1, 2_000_000 // max(n_landmarks * d, 1))
        for lo in range(0, pathlen, chunk):
            hi = min(lo + chunk, pathlen)
            enc = np.asarray(ssp_space.encode(
                vec_to_landmarks_data[lo:hi].reshape(-1, domain_dim)))
            enc = enc.reshape(hi - lo, n_landmarks, d)
            sum_vec_ssps[lo:hi] = np.einsum("tl,tld->td", mask[lo:hi], enc)

    velocity_func = TimeTable(vels_scaled, dt)
    landmark_vec_func = TimeTable(sum_vecs, dt)
    landmark_sp_func = TimeTable(sum_sps, dt)
    landmark_vecssp_func = TimeTable(sum_vec_ssps, dt)
    is_landmark_in_view = TimeTable(np.where(any_in_view, 0.0, 10.0), dt)

    def landmark_id_func(t):
        i = _step_of(t, dt, pathlen)
        return np.where(mask[i])[0] if any_in_view[i] else None

    return (velocity_func, vel_scaling_factor, is_landmark_in_view,
            landmark_id_func, landmark_sp_func, landmark_vec_func,
            landmark_vecssp_func)


def get_anchor_input_functions(ssp_space, vec_to_landmarks_data,
                               anchor_lms, anchor_locs, view_rad, dt=0.001):
    """The beacon perception stream for the anchor gate channels
    (``SLAMNetwork(gate_mode="auto_recovery", anchor=True)``): per step,
    the nearest surveyed landmark within ``view_rad`` gives its surveyed
    position SSP, the egocentric vector SSP to it and an in-view flag (0
    seen / 10 not).

    Returns ``(anchor_pos_func, anchor_vecssp_func,
    no_anchor_in_view_func)`` as TimeTables."""
    anchor_lms = np.asarray(anchor_lms, int)
    if anchor_lms.size == 0:
        raise ValueError(
            "no surveyed landmarks: the anchor survey came up empty "
            "(no landmark was ever nearest-in-view during the survey "
            "phase) — widen view_rad, lengthen the survey window, or "
            "pass explicit anchor indices")
    sub = vec_to_landmarks_data[:, anchor_lms, :]      # (T, K, n)
    dists = np.linalg.norm(sub, axis=2)                # (T, K)
    nearest = dists.argmin(axis=1)
    rows = np.arange(len(sub))
    seen = dists[rows, nearest] <= view_rad
    vec_ssp_rows = np.asarray(ssp_space.encode(sub[rows, nearest]))
    pos_rows = np.asarray(ssp_space.encode(
        np.asarray(anchor_locs)))[nearest]             # (T, d)
    s = seen[:, None]
    return (TimeTable(np.where(s, pos_rows, 0.0).astype(np.float32), dt),
            TimeTable(np.where(s, vec_ssp_rows, 0.0).astype(np.float32),
                      dt),
            TimeTable(np.where(seen, 0.0, 10.0).astype(np.float32), dt))
