"""Headline validation on the port: SLAM loop closure against pure
path-integration drift, with the flags, printed lines and JSON keys of the
JAX package's ``experiments/validate_loop_closure.py`` and ``--device``
(default ``cuda``) in place of ``--cpu``.

ONE Simulator holds the full SLAMNetwork at the reference ``run_slam.py``
defaults (200 s WhiteSignal path, 2x2 arena, hex ssp_dim 97, 50
landmarks, view radius 0.2, multi-landmark superposition inputs,
update_thres / shift_rate 0.2, voja 1e-4 / pes 5e-3) PLUS an identical
PathIntegration-only control integrating the same velocity stream, and
reports median / last-quarter / final decoded distance error for both.
``--tuned`` applies the tuned loop-closure configuration (update_thres
0.4, shift_rate 0.1, pes 2e-2, voja 1e-4, intercept 0.3).

    python -m sspslam_tpu_torch.experiments.validate_loop_closure \
        [--T 200] [--seed 0] [--tuned] [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from ..models import PathIntegration, SLAMNetwork, get_slam_input_functions2
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.sampling import Rd_sampling
from .common import decode_output


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=200.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--n-landmarks", type=int, default=50)
    ap.add_argument("--view-rad", type=float, default=0.2)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--update-thres", type=float, default=0.2)
    ap.add_argument("--shift-rate", type=float, default=0.2)
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--pes-lr", type=float, default=5e-3)
    ap.add_argument("--intercept", type=float, default=0.1)
    ap.add_argument("--tuned", action="store_true",
                    help="tuned config of tune_loop_closure: update_thres "
                         "0.4, shift_rate 0.1, pes 2e-2, voja 1e-4, "
                         "intercept 0.3")
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.tuned:
        args.update_thres, args.shift_rate = 0.4, 0.1
        args.pes_lr, args.voja_lr, args.intercept = 2e-2, 1e-4, 0.3
    return args


def build_program(args):
    """The world (path, space) and the Simulator of SLAM + the PI-only
    control on it.  Returns (sim, {"slam": probe, "pi": probe}, path,
    space, build seconds)."""
    dt = 0.001
    T = args.T
    n_steps = int(T / dt)
    radius = 1.0
    # the reference's random-path recipe: one band-limited WhiteSignal per
    # axis IS the path, min-max rescaled to fill [-0.9 r, 0.9 r]
    path = np.hstack([
        WhiteSignal(T, high=args.limit, seed=args.seed + i).run(T, dt=dt)
        for i in range(2)])[:n_steps]
    for i in range(2):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * 1.8 * radius - 0.9 * radius)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])

    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.2, domain_bounds=bounds)
    d = space.ssp_dim
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, 2, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=args.seed)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions2(space, lm_space, vels, vec_to_landmarks,
                                  args.view_rad)
    init = space.encode(path[:1]).flatten()

    with Network(seed=args.seed) as net:
        vel = Node(vel_f)
        init_node = Node(lambda t: init if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(space, lm_space, args.view_rad, args.n_landmarks,
                           args.pi_n_neurons, args.mem_n_neurons,
                           args.circonv_n_neurons,
                           update_thres=args.update_thres,
                           shift_rate=args.shift_rate,
                           voja_learning_rate=args.voja_lr,
                           pes_learning_rate=args.pes_lr,
                           intercept=args.intercept,
                           vel_scaling_factor=scale, seed=args.seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init_node, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        slam_p = Probe(slam.pathintegrator.output, synapse=0.05)

        # identical PI-only control, same velocity stream, no corrections
        pi_only = PathIntegration(space, args.pi_n_neurons, 0.05,
                                  scaling_factor=scale, stable=True)
        Connection(vel, pi_only.velocity_input, synapse=None)
        Connection(init_node, pi_only.input, synapse=None)
        pi_p = Probe(pi_only.output, synapse=0.05)

    t0 = time.time()
    sim = Simulator(net, seed=args.seed, device=args.device)
    return sim, {"slam": slam_p, "pi": pi_p}, path, space, time.time() - t0


def main(argv=None):
    args = parse_args(argv)
    dt = 0.001
    T = args.T
    n_steps = int(T / dt)
    sim, probes, path, space, build_s = build_program(args)
    d = space.ssp_dim
    print(f"build: {build_s:.1f}s", flush=True)
    sim.preload_inputs(n_steps)
    t0 = time.time()
    sim.compile(n_steps)
    print(f"compile: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    sim.run_steps(n_steps)
    sim.sync()
    el = time.time() - t0
    print(f"sim: {el:.2f}s ({n_steps / el:.0f} steps/s, both models in one "
          "program)", flush=True)

    skip = max(1, n_steps // 2000)
    path_s = path[::skip]
    q = len(path_s) // 4
    rows = []
    for label, probe in (("SLAM (loop closure)", probes["slam"]),
                         ("PI only (control)", probes["pi"])):
        out = sim.data[probe][::skip]
        est = decode_output(space, out, 2, grid=100, device=args.device)
        err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
        rows.append((label, np.median(err), np.median(err[-q:]), err[-1]))
    print(f"\nconfig: T={T}s, {args.n_landmarks} landmarks, "
          f"view_rad={args.view_rad}, ssp_dim={d}, seed={args.seed}")
    print(f"{'model':24s} {'median':>8s} {'last-q':>8s} {'final':>8s}")
    for label, m, lq, fin in rows:
        print(f"{label:24s} {m:8.3f} {lq:8.3f} {fin:8.3f}")
    (_, sm, slq, sfin), (_, pm, plq, pfin) = rows
    result = {
        "slam_median": round(float(sm), 4),
        "slam_lastq": round(float(slq), 4),
        "slam_final": round(float(sfin), 4),
        "pi_median": round(float(pm), 4),
        "pi_lastq": round(float(plq), 4),
        "pi_final": round(float(pfin), 4),
        "T": T, "ssp_dim": d, "n_landmarks": args.n_landmarks,
        "tuned": bool(args.tuned), "seed": args.seed}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
