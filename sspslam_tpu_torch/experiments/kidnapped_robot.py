"""Kidnapped-robot relocalization on the port: the learned landmark map
re-localizes the path integrator after a teleport the odometry never
sees.  The protocol, flags, printed lines and JSON keys of the JAX
package's ``experiments/kidnapped_robot.py``, with ``--device`` (default
``cuda``) in place of ``--cpu``.

  phase A [0, t_k):  the agent explores a WhiteSignal path and the
                     associative memory learns the landmark map;
  kidnap  at t_k:    the TRUE position jumps to the start of an
                     independent WhiteSignal path (the velocity input
                     reports zero for that step: odometry is blind);
  phase B [t_k, T]:  landmark observations reflect the new true position;
                     the correction loop must pull the path integrator
                     across the jump.

Three models run in one Simulator: strict throughout, adaptive, and a
PI-only control.  The adaptive model opens its gate and freezes its map
learning for a recovery window: scripted at the kidnap (default), by the
host's tick monitor (``--auto``), or by the ``auto_recovery`` gate's
stateful node inside the step (``--in-model``, optionally with surveyed
beacons, ``--anchor``).  The gate's thresholds are hoisted tables and the
learning rates 0-d tensors of ``sim.params``: recovery writes them IN
PLACE, so the captured CUDA graphs read the new values with no recapture
(assigning new tensors would leave the graphs reading the old ones).

    python -m sspslam_tpu_torch.experiments.kidnapped_robot [--T 200] \
        [--seed 0] [--in-model | --auto] [--model view] [--device cpu]

Prints one JSON line with pre/post error, jump size and recovery time.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import train
from ..models import (PathIntegration, SLAMNetwork, SLAMViewNetwork,
                      get_anchor_input_functions, get_slam_input_functions2,
                      get_slamview_input_functions)
from ..models.slam import _np_make_unitary
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.sampling import Rd_sampling
from .common import decode_output, kernel_value


def make_phase(T, dt, limit, seed, radius, dim=2):
    n = int(T / dt)
    path = np.hstack([
        WhiteSignal(T, high=limit, seed=seed + i).run(T, dt=dt)
        for i in range(dim)])[:n]
    for i in range(dim):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * 1.8 * radius - 0.9 * radius)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=200.0)
    ap.add_argument("--kidnap-frac", type=float, default=0.5,
                    help="kidnap time as a fraction of T")
    ap.add_argument("--recovery-window", type=float, default=25.0,
                    help="seconds the adaptive model's gate stays open "
                         "after the kidnap.  The correction pulls the VCO "
                         "state with time constant ~1/shift_rate, so the "
                         "window must cover several constants or the "
                         "handback to the strict gate happens outside its "
                         "agreement basin and drift resumes (measured: a "
                         "10 s window at shift 0.2 relapses)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="landmark",
                    choices=["landmark", "view"],
                    help="loop-closure family: 'landmark' = SLAMNetwork "
                         "(per-landmark bind/unbind map), 'view' = "
                         "SLAMViewNetwork (local-view-cell memory learning "
                         "view -> self-position directly, reference "
                         "slam_view.py).  Both support the scripted, "
                         "--auto and --in-model detection modes")
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--domain-dim", type=int, default=2,
                    help="spatial dimensionality (3 = the scaled config)")
    ap.add_argument("--length-scale", type=float, default=0.2,
                    help="SSP length scale (0.3 for the scaled 3-D config)")
    ap.add_argument("--decode-grid", type=int, default=None,
                    help="decode samples per axis (default 100 in 2-D, "
                         "30 in 3-D — the 100^3 bank would be 10^6 rows)")
    ap.add_argument("--auto-derive", action="store_true",
                    help="derive the detection thresholds from the SPACE "
                         "instead of hand constants: trigger = K(view_rad),"
                         " exit = 0.8 K(view_rad/2), cons-trigger = "
                         "(K(view_rad/2) + K(view_rad))/2, where K(r) is "
                         "the space's mean similarity at distance r.  "
                         "Rationale: healthy tracking error sits near "
                         "view_rad/2 (so the benign statistic floor is "
                         "~K(view_rad/2)), and the designed minimum "
                         "detectable teleport is view_rad (below it the "
                         "observation stream is consistent with the "
                         "tracked position — the measured benign blind "
                         "spot), so the post-kidnap level is ~K(view_rad)."
                         "  At the flagship config this REPRODUCES the "
                         "measured hand constants (derived 0.22/0.58/0.47 "
                         "vs hand 0.2/0.6/0.5)")
    ap.add_argument("--cleanup-samples", type=int, default=100,
                    help="clean-up bank samples per domain axis.  NOTE: "
                         "the default is the reference's 100/dim; in 3-D "
                         "that is a 10^6-row bank baked per model "
                         "(~0.8 GB, ~400 MFLOP/step) — 20-30 is the "
                         "scaled_slam-validated setting")
    ap.add_argument("--n-landmarks", type=int, default=50)
    ap.add_argument("--view-rad", type=float, default=0.2)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--update-thres", type=float, default=0.4)
    ap.add_argument("--shift-rate", type=float, default=0.1)
    ap.add_argument("--recovery-shift-rate", type=float, default=0.3,
                    help="shift rate while the recovery gate is open")
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--pes-lr", type=float, default=2e-2)
    ap.add_argument("--intercept", type=float, default=0.3)
    ap.add_argument("--auto", action="store_true",
                    help="autonomous tracking-loss detection: no knowledge "
                         "of the kidnap time; a tick monitor of "
                         "cos(map estimate, PI) enters/exits recovery mode")
    ap.add_argument("--in-model", action="store_true",
                    help="run the detection INSIDE the compiled step: the "
                         "adaptive model uses gate_mode='auto_recovery' (a "
                         "stateful node carrying the armed/EMA/timer "
                         "controller) and the whole run is one straight "
                         "simulation with zero host decisions")
    ap.add_argument("--tick-s", type=float, default=0.5,
                    help="monitor tick length (seconds) in --auto mode")
    ap.add_argument("--auto-trigger", type=float, default=0.2,
                    help="agreement below this (while landmarks in view) "
                         "counts toward a loss trigger")
    ap.add_argument("--auto-exit", type=float, default=0.6,
                    help="agreement above this counts toward recovery exit "
                         "(also the arming level: the monitor only arms "
                         "after tracking is first established)")
    ap.add_argument("--auto-ticks", type=int, default=3,
                    help="consecutive conclusive ticks required to switch "
                         "modes")
    ap.add_argument("--auto-debug", action="store_true",
                    help="print per-tick monitor stats")
    ap.add_argument("--auto-ema-tau", type=float, default=0.5,
                    help="agreement-EMA time constant (seconds). The "
                         "in-model controller smooths at dt granularity, "
                         "which needs a longer tau than the host tick "
                         "monitor to match its effective smoothing")
    ap.add_argument("--auto-familiar", type=float, default=0.3,
                    help="minimum mean recall magnitude for a tick to "
                         "count as evidence (unfamiliar landmarks give a "
                         "noise estimate, not a loss signal)")
    ap.add_argument("--auto-cons-trigger", type=float, default=None,
                    help="map-consistency trigger: EMA of cos(recall, "
                         "value) over familiar-landmark steps below this "
                         "enters recovery.  This signal survives FAST "
                         "learning rates: the agreement dip is erased "
                         "within ~1/(lr*a*n) s of a kidnap by the map "
                         "rewriting itself, and raw |PES error| is non-"
                         "discriminative (initial learning keeps it high "
                         "for minutes) — but PES drags recall COLINEARLY "
                         "toward the value, so cos(recall, value) ~ +1 "
                         "both during learning and steady tracking, while "
                         "a kidnap makes the value stream near-ORTHOGONAL "
                         "to the learned recall (measured: pre-kidnap "
                         "floor 0.79-0.85 vs post-kidnap EMA dips <0.5, "
                         "seeds 0-2).  Default: 0.6 for the host tick "
                         "monitor, 0.5 for the in-model dt-granular EMA")
    ap.add_argument("--auto-cons-frac", type=float, default=0.2,
                    help="minimum fraction of tick steps with a FAMILIAR "
                         "landmark (|recall| >= --auto-familiar) for the "
                         "consistency statistic to count as evidence")
    ap.add_argument("--auto-cons-ema-tau", type=float, default=0.25,
                    help="in-model map-consistency EMA time constant (s); "
                         "the EMA HOLDS across inconclusive steps "
                         "(relaxing between familiar encounters erases "
                         "the dip — measured)")
    ap.add_argument("--auto-min-dwell", type=float, default=8.0,
                    help="minimum seconds in recovery mode before handback "
                         "(the VCO state converges with time constant "
                         "~1/shift_rate; exiting on the first agreement "
                         "spike hands back outside the strict gate's "
                         "basin)")
    ap.add_argument("--min-jump", type=float, default=0.8,
                    help="minimum teleport distance (phase-B seeds are "
                         "scanned until the jump is at least this far)")
    ap.add_argument("--target-jump", type=float, default=None,
                    help="pick the phase-B candidate whose teleport "
                         "distance is CLOSEST to this value instead of the "
                         "farthest >= --min-jump (for sweeping detection "
                         "vs jump size; the path stays in-arena, so the "
                         "achievable jump is quantised by the candidate "
                         "pool — the JSON reports the actual distance)")
    ap.add_argument("--recovered-below", type=float, default=None,
                    help="recovery threshold on decoded distance error "
                         "(default: the view radius)")
    ap.add_argument("--anchor", action="store_true",
                    help="give the in-model controller one landmark with a "
                         "KNOWN allocentric pose (a surveyed beacon): adds "
                         "an absolute agreement channel cos(pi (x) vec, "
                         "phi(L0)) that measures the pose against the "
                         "WORLD instead of the learned map — the remedy "
                         "for both measured observability limits (the "
                         "masked 2x-vr kidnap, VALIDATION 'Part 8b', and "
                         "the co-drifting map).  During recovery the "
                         "correction pulls toward the map-independent "
                         "absolute pose whenever the anchor is in view. "
                         "Landmark family + --in-model only")
    ap.add_argument("--anchor-lm", type=int, default=None,
                    help="survey exactly this one landmark instead of the "
                         "top --anchor-k (diagnostics)")
    ap.add_argument("--anchor-k", type=int, default=10,
                    help="how many landmarks are surveyed (default 10 = "
                         "10%% of the scaled config's 100): chosen as the "
                         "most-often-nearest-in-view during the PRE-kidnap "
                         "phase — leak-free, where a deployment would "
                         "survey.  One anchor starves the evidence EMA "
                         "under single-nearest presentation (measured "
                         "0-1.4%% post-kidnap duty at 3-D/100 landmarks)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    ap.add_argument("--dump", type=str, default=None,
                    help="save subsampled monitor-signal traces (est/"
                         "recall/err/pi/in_view) to this npz for offline "
                         "detector design")
    return ap.parse_args(argv)


def make_world(args):
    """The host-made world: the two-phase path and its teleport, the
    velocities (zero at the teleport step), the space, the landmarks and
    the vectors to them, the derived thresholds (``--auto-derive``, written
    into ``args``) and the anchor tables (``--anchor``).  Prints the lines
    the JAX CLI prints while making it."""
    dt = 0.001
    T = args.T
    n_steps = int(T / dt)
    k_step = int(args.kidnap_frac * n_steps)
    rec_steps = min(int(args.recovery_window / dt), n_steps - k_step)
    radius = 1.0

    # two independent arena-filling paths; the concatenation point is the
    # teleport.  Phase-B seeds are scanned until the teleport is far (a
    # nearby "kidnap" is drift the strict gate can absorb)
    dim = args.domain_dim
    path_a = make_phase(args.kidnap_frac * T, dt, args.limit,
                        args.seed, radius, dim)[:k_step]
    path_b, jump = None, -1.0
    for i in range(64):
        cand = make_phase(T - args.kidnap_frac * T, dt, args.limit,
                          args.seed + 1000 + i, radius,
                          dim)[:n_steps - k_step]
        j = float(np.linalg.norm(cand[0] - path_a[-1]))
        if args.target_jump is not None:
            if jump < 0 or abs(j - args.target_jump) < abs(
                    jump - args.target_jump):
                path_b, jump = cand, j
            continue
        if j > jump:
            path_b, jump = cand, j
        if j >= args.min_jump:
            break
    path = np.concatenate([path_a, path_b])

    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    vels[k_step] = 0.0   # odometry is blind to the teleport

    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (dim, 1))
    space = HexagonalSSPSpace(dim, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=args.length_scale,
                              domain_bounds=bounds)
    d = space.ssp_dim
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, dim, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=args.seed)

    derived = None
    if args.auto_derive:
        k_half = kernel_value(space, args.view_rad / 2)
        k_full = kernel_value(space, args.view_rad)
        derived = {"k_half": k_half, "k_full": k_full}
        args.auto_trigger = round(k_full, 3)
        args.auto_exit = round(0.8 * k_half, 3)
        args.auto_cons_trigger = round(0.5 * (k_half + k_full), 3)
        print(f"derived thresholds from the space: K(vr/2)={k_half:.3f}, "
              f"K(vr)={k_full:.3f} -> trigger={args.auto_trigger}, "
              f"exit={args.auto_exit}, "
              f"cons-trigger={args.auto_cons_trigger}", flush=True)

    anchor_tables, anchor_stats, anchor_lms = None, None, None
    if args.anchor:
        if not args.in_model:
            raise SystemExit("--anchor requires --in-model (the anchor "
                             "channels live in the in-model auto-recovery "
                             "gate)")
        dists_all = np.linalg.norm(vec_to_landmarks, axis=2)
        nearest_all = dists_all.argmin(axis=1)
        iv_all = dists_all[np.arange(n_steps), nearest_all] <= args.view_rad
        if args.anchor_lm is None:
            counts = np.bincount(nearest_all[:k_step][iv_all[:k_step]],
                                 minlength=args.n_landmarks)
            anchor_lms = np.argsort(counts)[::-1][:args.anchor_k]
            anchor_lms = np.sort(anchor_lms[counts[anchor_lms] > 0])
        else:
            anchor_lms = np.array([args.anchor_lm])
        anchor_tables = get_anchor_input_functions(
            space, vec_to_landmarks, anchor_lms, obj_locs[anchor_lms],
            args.view_rad)
        # duty cycle of the beacon stream: ANY surveyed landmark within
        # the view radius (not necessarily the globally nearest)
        seen = (dists_all[:, anchor_lms] <= args.view_rad).any(axis=1)
        pre_f = float(seen[:k_step].mean())
        post_f = float(seen[k_step:].mean())
        anchor_stats = {"landmarks": anchor_lms.tolist(),
                        "in_view_frac_pre": round(pre_f, 4),
                        "in_view_frac_post": round(post_f, 4)}
        print(f"anchor: {len(anchor_lms)} surveyed landmarks "
              f"{anchor_lms.tolist()} (beacon in view "
              f"{100 * pre_f:.1f}% of phase A, {100 * post_f:.1f}% of "
              "phase B)", flush=True)
    return dict(dt=dt, T=T, n_steps=n_steps, k_step=k_step,
                rec_steps=rec_steps, dim=dim, path=path, vels=vels,
                jump=jump, space=space, d=d, obj_locs=obj_locs,
                vec_to_landmarks=vec_to_landmarks, lm_space=lm_space,
                derived=derived, anchor_lms=anchor_lms,
                anchor_tables=anchor_tables, anchor_stats=anchor_stats)


def build_network(args, world):
    """The three models in one Network (strict SLAM, adaptive SLAM, PI-only
    control, in that build order) with the monitor probes.  Returns (net,
    handles): ``probes`` {strict, adaptive, pi_only}, ``est``, ``recall``,
    ``err``, ``gate`` (``--in-model``) and the ``strict`` / ``adaptive``
    subnetworks."""
    space, lm_space = world["space"], world["lm_space"]
    d, vels = world["d"], world["vels"]
    vec_to_landmarks = world["vec_to_landmarks"]
    anchor_tables = world["anchor_tables"]
    if args.model == "view":
        (vel_f, scale, in_view_f, view_f) = get_slamview_input_functions(
            space, lm_space, vels, vec_to_landmarks, args.view_rad)
    else:
        (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
            get_slam_input_functions2(space, lm_space, vels,
                                      vec_to_landmarks, args.view_rad)
    init = space.encode(world["path"][:1]).flatten()
    nodes = {}

    def add_slam(gate_mode="reference"):
        gk = None
        if gate_mode == "auto_recovery":
            gk = {"recovery_shift_rate": args.recovery_shift_rate,
                  "trigger": args.auto_trigger,
                  "exit_thres": args.auto_exit,
                  "familiar": args.auto_familiar,
                  "ema_tau": args.auto_ema_tau,
                  "recovery_T": args.recovery_window,
                  "cons_trigger": (0.5 if args.auto_cons_trigger is None
                                   else args.auto_cons_trigger),
                  "cons_ema_tau": args.auto_cons_ema_tau}
            if anchor_tables is not None:
                # same K(vr) rationale as the agreement trigger
                gk["anchor_trigger"] = args.auto_trigger
        common = dict(
            update_thres=args.update_thres, shift_rate=args.shift_rate,
            voja_learning_rate=args.voja_lr,
            pes_learning_rate=args.pes_lr,
            vel_scaling_factor=scale, seed=args.seed,
            cleanup_samples_per_dim=args.cleanup_samples,
            gate_mode=gate_mode, gate_kwargs=gk)
        use_anchor = (anchor_tables is not None
                      and gate_mode == "auto_recovery")
        if args.model == "view":
            slam = SLAMViewNetwork(
                space, lm_space, args.view_rad, args.n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons, anchor=use_anchor, **common)
            Connection(nodes["view"], slam.view_input, synapse=None)
        else:
            slam = SLAMNetwork(
                space, lm_space, args.view_rad, args.n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons, intercept=args.intercept,
                anchor=use_anchor, **common)
            Connection(nodes["lm_id"], slam.landmark_id_input, synapse=None)
            Connection(nodes["lm_ssp"], slam.landmark_vec_ssp, synapse=None)
        if use_anchor:
            Connection(nodes["anc_pos"], slam.anchor_pos_input, synapse=None)
            Connection(nodes["anc_vec"], slam.anchor_vec_ssp, synapse=None)
            Connection(nodes["anc_iv"], slam.no_anchor_in_view, synapse=None)
        Connection(nodes["vel"], slam.velocity_input, synapse=None)
        Connection(nodes["init"], slam.pathintegrator.input, synapse=None)
        Connection(nodes["in_view"], slam.no_landmark_in_view, synapse=None)
        return slam, Probe(slam.pathintegrator.output, synapse=0.05)

    adaptive_mode = "auto_recovery" if args.in_model else "reference"
    handles = {"probes": {}}
    probes = handles["probes"]
    with Network(seed=args.seed) as net:
        nodes["vel"] = Node(vel_f)
        nodes["init"] = Node(lambda t: init if t < 0.05 else np.zeros(d))
        if args.model == "view":
            nodes["view"] = Node(view_f)
        else:
            nodes["lm_id"] = Node(sp_f)
            nodes["lm_ssp"] = Node(vecssp_f)
        nodes["in_view"] = Node(in_view_f)
        if anchor_tables is not None:
            nodes["anc_pos"] = Node(anchor_tables[0])
            nodes["anc_vec"] = Node(anchor_tables[1])
            nodes["anc_iv"] = Node(anchor_tables[2])
        handles["strict"], probes["strict"] = add_slam()
        adaptive, probes["adaptive"] = add_slam(adaptive_mode)
        handles["adaptive"] = adaptive
        # monitor signals: the map's own position estimate beside the PI
        # output, and the raw memory recall, whose magnitude is the
        # FAMILIARITY of the current landmark.  The view model has no
        # unbinding stage: its estimate IS make_unitary(recall), applied
        # on the host when reading est rows
        handles["est"] = Probe(adaptive.assomemory.recall
                               if args.model == "view"
                               else adaptive.position_estimate.output,
                               synapse=0.05)
        handles["recall"] = Probe(adaptive.assomemory.recall, synapse=0.05)
        handles["err"] = Probe(adaptive.assomemory.error, synapse=0.05)
        if args.in_model:
            # the controller's suppress channel records its own enter /
            # exit decisions; 50 ms sampling is plenty
            handles["gate"] = Probe(adaptive.update_state, synapse=None,
                                    sample_every=0.05)
        pi_only = PathIntegration(space, args.pi_n_neurons, 0.05,
                                  scaling_factor=scale, stable=True)
        Connection(nodes["vel"], pi_only.velocity_input, synapse=None)
        Connection(nodes["init"], pi_only.input, synapse=None)
        probes["pi_only"] = Probe(pi_only.output, synapse=0.05)
    return net, handles


def recovery_controls(sim, adaptive, args):
    """``(enter_recovery, exit_recovery, saved_rates)`` for the adaptive
    model of ``sim``.  Recovery opens its gate (update_thres -2, the
    recovery shift rate) and FREEZES its map learning (its PES and Voja
    rates 0): while the self-estimate is known wrong, PES would write
    wrong landmark locations into the map.  Every write is in place, into
    the tensors the captured graphs read; the rates are restored from
    clones taken here.  The gate's table and the rates are found through
    the adaptive model's own gate node and learned connections (the
    second SLAM in build order)."""
    hoisted = sim.params["hoisted"]
    gates = [k for k, v in hoisted.items() if "update_thres" in v]
    assert len(gates) == 2, gates
    gate = hoisted[sim.model.node_info[id(adaptive.update_state)][
        "hoisted_key"]]
    lr = sim.params["hyper"]["lr"]
    assert len(lr) == 4, sorted(lr)
    rates = [lr[train.learning_rate_path(sim, c).split("/")[-1]]
             for c in (adaptive.assomemory.conn_in,
                       adaptive.assomemory.conn_out)]
    saved = [r.clone() for r in rates]

    def enter_recovery():
        gate["update_thres"].fill_(-2.0)
        gate["shift_rate"].fill_(args.recovery_shift_rate)
        for r in rates:
            r.zero_()

    def exit_recovery():
        gate["update_thres"].fill_(args.update_thres)
        gate["shift_rate"].fill_(args.shift_rate)
        for r, s in zip(rates, saved):
            r.copy_(s)

    return enter_recovery, exit_recovery, saved


def _tick_rows(sim, bps, chunk0, n):
    """This tick's last ``n`` rows of each probe in ``bps``, from the
    segment chunks appended since ``chunk0``, brought to the host once."""
    return {bp.index: torch.cat(sim._probe_data[bp.index][chunk0:])[-n:]
            .cpu().numpy() for bp in bps}


def auto_monitor(sim, handles, world, args, enter_recovery, exit_recovery):
    """``--auto``: a tick-granular monitor of the agreement statistic the
    gate itself uses, cos(map estimate, PI output), and of the map
    consistency cos(recall, value), entering and leaving recovery with no
    knowledge of the kidnap time.  Returns the JSON's ``auto`` entry."""
    dt, n_steps, k_step = world["dt"], world["n_steps"], world["k_step"]
    bp_of = {bp.obj: bp for bp in sim.model.probes}
    est_bp, rec_bp = bp_of[handles["est"]], bp_of[handles["recall"]]
    err_bp, api_bp = bp_of[handles["err"]], bp_of[handles["probes"][
        "adaptive"]]
    in_view_row = (np.linalg.norm(world["vec_to_landmarks"], axis=2)
                   .min(axis=1) <= args.view_rad)
    tick = max(1, int(args.tick_s / dt))
    min_dwell = max(1, int(args.auto_min_dwell / args.tick_s))
    armed, mode = False, "normal"
    low, high, dwell = 0, 0, 0
    ema, cons_ema = None, None
    cons_trig = (0.6 if args.auto_cons_trigger is None
                 else args.auto_cons_trigger)
    events = []
    done = 0
    while done < n_steps:
        n = min(tick, n_steps - done)
        # run_steps splits into segments, each appending its own probe
        # chunk: remember how many exist so this tick's rows can be
        # reassembled exactly
        chunk0 = len(sim._probe_data[rec_bp.index])
        sim.run_steps(n)
        rows = in_view_row[done:done + n]
        done += n
        t_now = done * dt
        if rows.mean() < 0.5:
            continue   # inconclusive tick: hold all counters
        got = _tick_rows(sim, (est_bp, rec_bp, err_bp, api_bp), chunk0, n)
        rec_all = got[rec_bp.index]
        rn = np.linalg.norm(rec_all, axis=1)
        familiar = float(np.mean(rn[rows]))
        est = got[est_bp.index][rows]
        if args.model == "view":
            est = np.atleast_2d(_np_make_unitary(est))
        pi = got[api_bp.index][rows]
        # map-consistency evidence: cos(recall, value) over steps with a
        # FAMILIAR landmark (value = recall - err)
        err_all = got[err_bp.index]
        fam_rows = rows & (rn >= args.auto_familiar)
        cons_tick = float(fam_rows.mean()) >= args.auto_cons_frac
        cons = None
        if cons_tick:
            r_f = rec_all[fam_rows]
            v_f = r_f - err_all[fam_rows]
            cons = float(np.mean(
                np.sum(r_f * v_f, axis=1)
                / (np.linalg.norm(r_f, axis=1)
                   * np.linalg.norm(v_f, axis=1) + 1e-9)))
            cons_ema = (cons if cons_ema is None
                        else 0.5 * cons_ema + 0.5 * cons)
        agree = float(np.mean(
            np.sum(est * pi, axis=1)
            / (np.linalg.norm(est, axis=1)
               * np.linalg.norm(pi, axis=1) + 1e-9)))
        if args.auto_debug:
            print(f"  [tick] t={t_now:6.1f}s inview={rows.mean():.2f} "
                  f"recall|={familiar:.3f} agree={agree:+.2f} "
                  f"cons={'n/a' if cons is None else f'{cons:+.2f}'} "
                  f"mode={mode}", flush=True)
        # counters HOLD on ticks where their channel is inconclusive
        fam_tick = familiar >= args.auto_familiar
        if mode == "normal":
            if fam_tick:
                ema = agree if ema is None else 0.5 * ema + 0.5 * agree
                if ema >= args.auto_exit:
                    armed = True
                low = (low + 1
                       if (armed and ema < args.auto_trigger) else 0)
            cons_low = (armed and cons_tick and cons_ema is not None
                        and cons_ema < cons_trig)
            if low >= args.auto_ticks or cons_low:
                why = "map inconsistency" if cons_low else "agreement"
                mode, low, dwell = "recovery", 0, 0
                cons_ema = None   # stale evidence must not re-trigger
                enter_recovery()
                events.append({"t": round(t_now, 2),
                               "event": "enter_recovery", "why": why})
                print(f"  [auto] t={t_now:.1f}s tracking loss "
                      f"({why}: agreement "
                      f"{'n/a' if ema is None else f'{ema:.2f}'}, cons "
                      f"{'n/a' if cons is None else f'{cons:.2f}'})"
                      " -> recovery mode", flush=True)
        else:
            if not fam_tick:
                continue
            ema = agree if ema is None else 0.5 * ema + 0.5 * agree
            dwell += 1
            high = high + 1 if ema >= args.auto_exit else 0
            if high >= args.auto_ticks and dwell >= min_dwell:
                mode, high = "normal", 0
                exit_recovery()
                events.append({"t": round(t_now, 2),
                               "event": "exit_recovery"})
                print(f"  [auto] t={t_now:.1f}s agreement restored "
                      f"({ema:.2f}) -> strict gate", flush=True)
    if mode == "recovery":
        exit_recovery()
    enters = [e["t"] for e in events if e["event"] == "enter_recovery"]
    exits = [e["t"] for e in events if e["event"] == "exit_recovery"]
    kidnap_t = k_step * dt
    detect = next((t for t in enters if t >= kidnap_t), None)
    return {
        "events": events,
        "false_triggers": sum(1 for t in enters if t < kidnap_t),
        "detect_s": None if detect is None
        else round(detect - kidnap_t, 2),
        "recovery_exit_s": None if not exits or detect is None
        else next((round(t - kidnap_t, 2) for t in exits
                   if t > detect), None),
    }


def main(argv=None):
    args = parse_args(argv)
    rec_thresh = (args.view_rad if args.recovered_below is None
                  else args.recovered_below)
    if (args.auto or args.in_model) and args.pes_lr >= 1e-2:
        print(f"NOTE: pes_lr={args.pes_lr:g} re-learns the map to match "
              "the wrong path integrator within ~1 s of a kidnap, erasing "
              "the agreement dip — detection in this regime rides the "
              "map-consistency channel cos(recall, value), whose kidnap "
              "signature is learning-rate-invariant (--auto-cons-trigger).",
              file=sys.stderr, flush=True)
    world = make_world(args)
    dt, T, n_steps = world["dt"], world["T"], world["n_steps"]
    k_step, rec_steps = world["k_step"], world["rec_steps"]
    dim, path, space, d = (world["dim"], world["path"], world["space"],
                           world["d"])
    net, handles = build_network(args, world)
    probes = handles["probes"]

    t0 = time.time()
    sim = Simulator(net, seed=args.seed, device=args.device)
    print(f"build: {time.time() - t0:.1f}s", flush=True)
    enter_recovery, exit_recovery, _ = recovery_controls(
        sim, handles["adaptive"], args)

    sim.preload_inputs(n_steps)
    t0 = time.time()
    sim.compile(min(n_steps, 1000))
    print(f"compile: {time.time() - t0:.1f}s", flush=True)

    auto_stats = None
    t0 = time.time()
    if args.in_model:
        # the controller lives in the state: one straight simulation,
        # zero host decisions
        if args.auto_debug:
            # stepped in ticks only to READ the controller's state
            tick = max(1, int(args.tick_s / dt))
            (slot,) = sim.state["nodes"]
            done = 0
            while done < n_steps:
                n = min(tick, n_steps - done)
                sim.run_steps(n)
                done += n
                armed, ema, timer, cons_ema = (
                    sim.state["nodes"][slot].cpu().numpy()[:4])
                print(f"  [state] t={done * dt:6.1f}s armed={armed:.0f} "
                      f"ema={ema:+.2f} timer={timer * dt:5.1f}s "
                      f"cons={cons_ema:+.2f}", flush=True)
        else:
            sim.run_steps(n_steps)
    elif not args.auto:
        # scripted schedule: the experimenter knows the kidnap time
        sim.run_steps(k_step)                   # phase A: both gates strict
        enter_recovery()
        sim.run_steps(rec_steps)                # recovery window
        exit_recovery()
        sim.run_steps(n_steps - k_step - rec_steps)  # phase B, strict again
    else:
        auto_stats = auto_monitor(sim, handles, world, args,
                                  enter_recovery, exit_recovery)
    sim.sync()
    el = time.time() - t0
    print(f"sim: {el:.2f}s ({n_steps / el:.0f} steps/s, three models in "
          "one program)", flush=True)

    if args.dump:
        # subsampled monitor-signal traces for offline detector design
        sk = 5
        np.savez_compressed(
            args.dump,
            est=sim.data[handles["est"]][::sk].astype(np.float32),
            recall=sim.data[handles["recall"]][::sk].astype(np.float32),
            err=sim.data[handles["err"]][::sk].astype(np.float32),
            pi=sim.data[probes["adaptive"]][::sk].astype(np.float32),
            in_view=(np.linalg.norm(world["vec_to_landmarks"], axis=2)
                     .min(axis=1) <= args.view_rad)[::sk],
            path=path[::sk].astype(np.float32), skip=sk, dt=dt,
            k_step=k_step)
        print(f"dumped monitor traces to {args.dump}", flush=True)

    if args.in_model:
        # the controller's decisions from its own suppress channel (last
        # output element, sampled every 50 ms)
        g = sim.data[handles["gate"]]
        sup = g[:, -1] > 5.0
        t_g = 0.05 * (1 + np.arange(len(sup)))
        edges = np.flatnonzero(np.diff(sup.astype(np.int8)) == 1) + 1
        enters = [float(t_g[i]) for i in edges]
        kidnap_t = k_step * dt
        detect = next((t for t in enters if t >= kidnap_t), None)
        auto_stats = {
            "mode": "in_model",
            "false_triggers": sum(1 for t in enters if t < kidnap_t),
            "detect_s": None if detect is None
            else round(detect - kidnap_t, 2),
            "recovery_frac_post": round(float(
                sup[t_g >= kidnap_t].mean()), 3) if len(sup) else None,
        }
        print(f"  [in-model] enters={['%.1f' % t for t in enters]}",
              flush=True)

    # decode on a subsampled grid
    skip = max(1, n_steps // 2000)
    idx = np.arange(0, n_steps, skip)
    path_s = path[idx]
    k_s = int(np.searchsorted(idx, k_step))
    result = {"model": args.model, "domain_dim": dim,
              "jump": round(world["jump"], 3), "T": T,
              "kidnap_t": k_step * dt,
              "recovery_window": rec_steps * dt, "ssp_dim": d,
              "n_landmarks": args.n_landmarks, "seed": args.seed,
              "update_thres": args.update_thres,
              "recovered_below": rec_thresh}
    if auto_stats is not None:
        result["auto"] = auto_stats
    if world["anchor_stats"] is not None:
        result["anchor"] = world["anchor_stats"]
    if args.auto_derive:
        result["derived_thresholds"] = {
            "trigger": args.auto_trigger, "exit": args.auto_exit,
            "cons_trigger": args.auto_cons_trigger}
    print(f"\nteleport distance: {world['jump']:.3f}  (recovery threshold "
          f"{rec_thresh})")
    print(f"{'model':12s} {'pre-err':>8s} {'post-err':>9s} "
          f"{'recovery-s':>11s}")
    grid = args.decode_grid or (100 if dim == 2 else 30)
    for label, probe in probes.items():
        out = sim.data[probe][idx]
        est = decode_output(space, out, dim, grid=grid, device=args.device)
        err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
        pre = float(np.median(err[k_s // 2:k_s]))
        post = float(np.median(err[k_s + (len(err) - k_s) // 2:]))
        # first settled recovery: error below threshold and staying below
        # for >= 3 s of simulated time (the decoded argmax can snap to the
        # new position seconds before the VCO state converges)
        rec = None
        hold = max(1, int(3.0 / (dt * skip)))
        below = err[k_s:] < rec_thresh
        for i in range(len(below) - hold):
            if below[i:i + hold].all():
                rec = float(idx[k_s + i] * dt - k_step * dt)
                break
        result[label] = {"pre_err": round(pre, 4),
                         "post_err": round(post, 4),
                         "recovery_s": None if rec is None else round(rec, 2)}
        rs = "never" if rec is None else f"{rec:.1f}"
        print(f"{label:12s} {pre:8.3f} {post:9.3f} {rs:>11s}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
