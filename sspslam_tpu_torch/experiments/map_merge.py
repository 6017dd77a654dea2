"""Multi-agent map merging on the port: fuse two agents' learned maps by
state arithmetic, then localize against the merged map.  The protocol,
flags, printed lines and JSON keys of the JAX package's
``experiments/map_merge.py``, with ``--device`` (default ``cuda``) in
place of ``--cpu``.

The whole learned map (PES decoders and Voja encoders) is a leaf of the
Simulator's state, so maps are data.  Two agents with identically drawn
networks explore disjoint halves of the arena; their maps merge by

    decoders:  d_merged   = d_A + d_B          (PES starts at the zero
                                                function: learned deltas
                                                add)
    encoders:  enc_merged = enc_0 + (enc_A - enc_0) + (enc_B - enc_0)
                                               (Voja drifts add; the
                                                drifted neuron sets are
                                                about disjoint)

computed as ``base + (A - base) + (B - base)`` for every learned leaf, and
the merged map is written into a third, learning-frozen "localization
mode" Simulator that runs a full-arena trajectory.  Controls: each single
map, and the empty map.  The third Simulator's learning rates are zeroed
in place before its first capture, and each map is copied into its state
tensors in place after a reset, so its graphs are captured once for all
four conditions.

Identical network draws across the three Simulators come from identical
construction; the only model parameter derived from DATA is the velocity
normalisation, so the last velocity row of every agent is pinned to the
common maximum.

    python -m sspslam_tpu_torch.experiments.map_merge [--T-explore 100] \
        [--T-test 60] [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from ..models import SLAMNetwork, get_slam_input_functions2
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.sampling import Rd_sampling
from .common import decode_output, learned_base


def make_path(T, dt, limit, seed, x_range, y_range):
    n = int(T / dt)
    path = np.hstack([
        WhiteSignal(T, high=limit, seed=seed + i).run(T, dt=dt)
        for i in range(2)])[:n]
    for i, (lo_t, hi_t) in enumerate((x_range, y_range)):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * (hi_t - lo_t) + lo_t)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T-explore", type=float, default=100.0)
    ap.add_argument("--T-test", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--n-landmarks", type=int, default=50)
    ap.add_argument("--view-rad", type=float, default=0.2)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--test-limit", type=float, default=None,
                    help="frequency content of the TEST path (default: "
                         "--limit). Slower test paths make excursions "
                         "into unmapped territory longer, which is what "
                         "separates a half map from the merged one")
    ap.add_argument("--update-thres", type=float, default=0.4)
    ap.add_argument("--shift-rate", type=float, default=0.1)
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--pes-lr", type=float, default=2e-2)
    ap.add_argument("--intercept", type=float, default=0.3)
    ap.add_argument("--recovery-shift-rate", type=float, default=0.3,
                    help="recovery-mode shift rate for --eval-gate "
                         "auto_recovery")
    ap.add_argument("--eval-gate", choices=("reference", "auto_recovery"),
                    default="reference",
                    help="gate mode of the localization-mode agent. "
                         "'auto_recovery' starts ARMED (arm_at_start: the "
                         "map is injected and trusted), so a map whose "
                         "coverage the agent first reaches only after "
                         "drifting re-engages via recovery instead of "
                         "locking out")
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    return ap.parse_args(argv)


def make_worlds(args):
    """The three paths (agent A's left half, agent B's right half, the
    full-arena test path), their velocities with the last row of each
    pinned to the common maximum, the space, the landmarks and their SPs."""
    dt = 0.001
    radius = 1.0
    n_explore = int(args.T_explore / dt)
    n_test = int(args.T_test / dt)
    path_A = make_path(args.T_explore, dt, args.limit, args.seed,
                       (-0.9, -0.05), (-0.9, 0.9))[:n_explore]
    path_B = make_path(args.T_explore, dt, args.limit, args.seed + 500,
                       (0.05, 0.9), (-0.9, 0.9))[:n_explore]
    test_limit = args.limit if args.test_limit is None else args.test_limit
    path_T = make_path(args.T_test, dt, test_limit, args.seed + 900,
                       (-0.9, 0.9), (-0.9, 0.9))[:n_test]

    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.2, domain_bounds=bounds)
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, 2, seed=args.seed) - 0.5)
    lm_space = SPSpace(args.n_landmarks, space.ssp_dim, seed=args.seed)

    # velocity normalisation is the ONE model parameter derived from the
    # input data: pin the final velocity row of every agent to the common
    # maximum so the three adapters compute the SAME scale
    all_vels = [(1 / dt) * np.diff(p, axis=0, prepend=p[:1])
                for p in (path_A, path_B, path_T)]
    A = space.phase_matrix
    freqs = [np.abs(A @ v.T).max() for v in all_vels]
    vmax_owner = all_vels[int(np.argmax(freqs))]
    vmax_row = vmax_owner[np.argmax(np.abs(A @ vmax_owner.T).max(axis=0))]
    for v in all_vels:
        v[-1] = vmax_row
    return dict(paths=(path_A, path_B, path_T), vels=all_vels, space=space,
                obj_locs=obj_locs, lm_space=lm_space, n_test=n_test)


def build_program(args, world, path, vels, gate_mode="reference"):
    """One agent's Simulator (SLAMNetwork on ``path``), its PI probe and
    its velocity scale."""
    space, lm_space = world["space"], world["lm_space"]
    d = space.ssp_dim
    vec_to_lm = world["obj_locs"][None, :, :] - path[:, None, :]
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions2(space, lm_space, vels, vec_to_lm,
                                  args.view_rad)
    init = space.encode(path[:1]).flatten()
    with Network(seed=args.seed) as net:
        vel = Node(vel_f)
        init_node = Node(lambda t: init if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(
            space, lm_space, args.view_rad, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons,
            args.circonv_n_neurons, update_thres=args.update_thres,
            shift_rate=args.shift_rate,
            voja_learning_rate=args.voja_lr,
            pes_learning_rate=args.pes_lr, intercept=args.intercept,
            vel_scaling_factor=scale, seed=args.seed,
            gate_mode=gate_mode,
            gate_kwargs=({"arm_at_start": True,
                          "recovery_shift_rate": args.recovery_shift_rate}
                         if gate_mode == "auto_recovery" else None))
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init_node, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p = Probe(slam.pathintegrator.output, synapse=0.05)
    return Simulator(net, seed=args.seed, device=args.device), p, scale


def merge(la, lb, base):
    """The merged map: ``base + (A - base) + (B - base)`` for every
    learned leaf, in float32 (the JAX package's formula, op for op)."""
    return {k: base[k] + (la[k] - base[k]) + (lb[k] - base[k]) for k in la}


def by_prefix(keys):
    """{rule: slot} of a model's learned slots: slots are keyed by
    built-connection index, which shifts when a gate adds connections;
    each model has exactly one Voja and one PES slot."""
    return {k.split("_")[0]: k for k in keys}


def inject(sim, learned):
    """Reset ``sim`` to its initial state (keeping its preloaded inputs and
    graphs) and copy ``learned`` ({rule: leaf}) into its learned state
    tensors in place."""
    sim.reset(keep_inputs=True)
    dst_of = by_prefix(sim.state["learned"])
    for rule, leaf in learned.items():
        sim.state["learned"][dst_of[rule]].copy_(leaf)


def main(argv=None):
    args = parse_args(argv)
    world = make_worlds(args)
    path_A, path_B, path_T = world["paths"]
    all_vels = world["vels"]
    space = world["space"]
    d = space.ssp_dim
    n_test = world["n_test"]

    def explore(path, vels, tag):
        t0 = time.time()
        sim, _, scale = build_program(args, world, path, vels)
        sim.preload_inputs(len(path))
        sim.run_steps(len(path))
        sim.sync()
        learned = {k: v.clone() for k, v in sim.state["learned"].items()}
        print(f"agent {tag}: explored {len(path)} steps in "
              f"{time.time() - t0:.1f}s (scale {scale:.4f})", flush=True)
        return learned, learned_base(sim)

    learned_A, base = explore(path_A, all_vels[0], "A")
    learned_B, _ = explore(path_B, all_vels[1], "B")
    assert set(learned_A) == set(learned_B) == set(base)
    src_of = by_prefix(base)
    assert set(src_of) == {"voja", "pes"}

    maps = {"merged": merge(learned_A, learned_B, base),
            "agent_A_only": learned_A,
            "agent_B_only": learned_B,
            "empty": base}

    # localization mode: learning frozen (in place, before any capture),
    # each map injected into the state
    eval_sim, eval_probe, _ = build_program(args, world, path_T,
                                            all_vels[2],
                                            gate_mode=args.eval_gate)
    for rate in eval_sim.params["hyper"]["lr"].values():
        rate.zero_()
    assert set(by_prefix(eval_sim.model.learned_init)) == {"voja", "pes"}

    left = path_T[:, 0] < 0
    result = {"T_explore": args.T_explore, "T_test": args.T_test,
              "ssp_dim": d, "n_landmarks": args.n_landmarks,
              "seed": args.seed}
    print(f"\n{'map':14s} {'median':>8s} {'last-q':>8s} "
          f"{'left-half':>10s} {'right-half':>11s}")
    for label, learned in maps.items():
        inject(eval_sim, {p: learned[src_of[p]] for p in src_of})
        if eval_sim._preloaded is None:
            eval_sim.preload_inputs(n_test)
        eval_sim.run_steps(n_test)
        eval_sim.sync()
        out = eval_sim.data[eval_probe]
        skip = max(1, n_test // 1500)
        est = decode_output(space, out[::skip], 2, grid=100,
                            device=args.device)
        err = np.sqrt(np.sum((path_T[::skip] - est) ** 2, axis=1))
        lmask = left[::skip][:len(err)]
        q = max(1, len(err) // 4)
        row = {
            "median": round(float(np.median(err)), 4),
            "lastq": round(float(np.median(err[-q:])), 4),
            "p90": round(float(np.quantile(err, 0.9)), 4),
            "left_median": round(float(np.median(err[lmask])), 4)
            if lmask.any() else None,
            "right_median": round(float(np.median(err[~lmask])), 4)
            if (~lmask).any() else None,
            # excursion metric: p90 per half (medians hide the drift
            # spikes accumulated while away from the mapped half)
            "left_p90": round(float(np.quantile(err[lmask], 0.9)), 4)
            if lmask.any() else None,
            "right_p90": round(float(np.quantile(err[~lmask], 0.9)), 4)
            if (~lmask).any() else None,
        }
        result[label] = row
        print(f"{label:14s} {row['median']:8.3f} {row['lastq']:8.3f} "
              f"{row['left_median']:10.3f} {row['right_median']:11.3f} "
              f"(p90 {row['left_p90']:.3f}/{row['right_p90']:.3f})",
              flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
