"""Closed-loop navigation on the port: a host controller steers the agent
to a goal using the SLAM network's OWN decoded position estimate.  The
flags, protocol and printed JSON line of the JAX package's
``experiments/closed_loop_nav.py``, with ``--device`` (default ``cuda``)
in place of ``--cpu``.

The world state lives on the host and responds to the commanded velocity,
so estimation errors feed back into the trajectory:

  1. explore: a scripted lap past the landmarks (the PES / Voja memory
     learns the landmark -> position map online),
  2. navigate: u = kp * (goal - decode(PI output)), zero-order hold per
     control tick; the TRUE pose integrates u while the network only ever
     sees velocity and egocentric landmark views.

The exchange is tick-granular (:class:`ClosedLoopSession`): the device
integrates ``--tick-steps`` dt of spiking dynamics per exchange (one
replayed CUDA graph on the card); the host computes the sensor view and
the control law.  The reported tick latency is the full round trip
(input copy, replay, probe pull), so ``control_rate_hz`` is the control
rate this stack reaches on this host and card.

    python -m sspslam_tpu_torch.experiments.closed_loop_nav \
        [--tick-steps 50] [--goal 0.6 -0.5] [--device cpu]

Prints one JSON line with the navigation outcome and latency stats.
"""

import argparse
import json
import sys
import time

import numpy as np

from ..models import SLAMNetwork
from ..nef import (ClosedLoopSession, Connection, Network, Node, Probe,
                   Simulator, clamp_table)
from ..sspspace import HexagonalSSPSpace, SPSpace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=500)
    ap.add_argument("--mem-n-neurons", type=int, default=700)
    ap.add_argument("--circonv-n-neurons", type=int, default=70)
    ap.add_argument("--n-landmarks", type=int, default=8)
    ap.add_argument("--view-rad", type=float, default=0.4)
    ap.add_argument("--tick-steps", type=int, default=50,
                    help="dt steps per control tick (50 -> 20 Hz control)")
    ap.add_argument("--explore-T", type=float, default=8.0)
    ap.add_argument("--nav-T", type=float, default=16.0)
    ap.add_argument("--goal", type=float, nargs=2, default=[0.6, -0.5])
    ap.add_argument("--kp", type=float, default=1.2)
    ap.add_argument("--stop-radius", type=float, default=0.12)
    ap.add_argument("--vmax", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-grid", type=int, default=61)
    ap.add_argument("--device", default="cuda",
                    help="torch device the network runs on (cuda | cpu)")
    args = ap.parse_args(argv)
    dt = 0.001

    rng = np.random.default_rng(args.seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    landmarks = rng.uniform(-0.75, 0.75, size=(args.n_landmarks, 2))
    lm_space = SPSpace(args.n_landmarks, d, seed=args.seed)
    lm_sps = np.asarray(lm_space.vectors)

    # velocity scaling chosen from the SPEED BOUND (the recorded-data
    # adapters derive it from max |phase_matrix @ v| over the whole
    # trajectory, slam.py:371; live we only know |v| <= vmax)
    row_norms = np.linalg.norm(np.asarray(space.phase_matrix), axis=1)
    scale = 1.0 / (args.vmax * float(row_norms.max()) * 1.05)

    pos0 = np.array([-0.6, 0.6])
    ssp0 = np.asarray(space.encode(pos0[None])).flatten()

    with Network(seed=args.seed) as net:
        vel = Node(lambda t: np.zeros(2))
        init = Node(clamp_table(ssp0, 0.05, dt))
        lm_sp = Node(lambda t: np.zeros(d))
        lm_vecssp = Node(lambda t: np.zeros(d))
        in_view = Node(lambda t: np.asarray([10.0]))
        slam = SLAMNetwork(space, lm_space, args.view_rad, args.n_landmarks,
                           pi_n_neurons=args.pi_n_neurons,
                           mem_n_neurons=args.mem_n_neurons,
                           circonv_n_neurons=args.circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=80, seed=args.seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_sp, slam.landmark_id_input, synapse=None)
        Connection(lm_vecssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p_out = Probe(slam.pathintegrator.output, synapse=0.02)

    t0 = time.time()
    sim = Simulator(net, seed=args.seed, device=args.device)
    print(f"build: {time.time() - t0:.1f}s", file=sys.stderr)

    sess = ClosedLoopSession(
        sim, live_inputs=[vel, lm_sp, lm_vecssp, in_view],
        outputs=[p_out], tick_steps=args.tick_steps)
    t0 = time.time()
    sess.compile()
    print(f"tick compile+warmup: {time.time() - t0:.1f}s", file=sys.stderr)

    # host-side decoder: argmax over an encoded grid (the from-set decode)
    g = np.linspace(-1.0, 1.0, args.decode_grid)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    bank = np.asarray(space.encode(grid), np.float32)

    def decode(ssp_row):
        return grid[np.argmax(bank @ np.asarray(ssp_row, np.float32))]

    def sense(pos):
        """Egocentric landmark view from the TRUE pose (nearest-in-view,
        the get_slam_input_functions convention, slam.py:378-398)."""
        vecs = landmarks - pos[None]
        dists = np.linalg.norm(vecs, axis=1)
        j = int(np.argmin(dists))
        if dists[j] <= args.view_rad:
            vecssp = np.asarray(space.encode(vecs[j][None]),
                                np.float32).flatten()
            return lm_sps[j].astype(np.float32), vecssp, np.asarray([0.0])
        return (np.zeros(d, np.float32), np.zeros(d, np.float32),
                np.asarray([10.0]))

    tick_T = args.tick_steps * dt
    goal = np.asarray(args.goal, float)
    pos = pos0.copy()
    lat, true_path, est_path = [], [], []

    def run_phase(n_ticks, control):
        nonlocal pos
        est = pos.copy()
        for i in range(n_ticks):
            u = control(i, est)
            sp_row, vecssp_row, view_row = sense(pos)
            t_tick = time.time()
            out = sess.tick({vel: (u * scale).astype(np.float32),
                             lm_sp: sp_row, lm_vecssp: vecssp_row,
                             in_view: view_row})
            lat.append(time.time() - t_tick)
            est = decode(out[p_out][-1])
            pos = np.clip(pos + u * tick_T, -1.0, 1.0)
            true_path.append(pos.copy())
            est_path.append(est.copy())
        return est

    # phase 1: scripted exploration lap (the controller ignores the
    # estimate; the memory learns landmark -> position associations)
    n_exp = int(args.explore_T / tick_T)
    center = landmarks.mean(axis=0)
    radius = 0.85 * np.abs(landmarks - center).max()

    def explore_control(i, est):
        ang = 2 * np.pi * (i / max(n_exp - 1, 1))
        target = center + radius * np.array([np.cos(ang), np.sin(ang)])
        u = 2.0 * (target - pos)
        n = np.linalg.norm(u)
        return u * (args.vmax / n) if n > args.vmax else u

    run_phase(n_exp, explore_control)
    explore_err = np.linalg.norm(
        np.array(true_path) - np.array(est_path), axis=1)

    # phase 2: navigate to the goal on the NEURAL estimate only (with the
    # usual stop deadband: command zero once the estimate says "arrived",
    # else a P-controller on a noisy estimate orbits the goal forever)
    def nav_control(i, est):
        err = goal - est
        if np.linalg.norm(err) < args.stop_radius:
            return np.zeros(2)
        u = args.kp * err
        n = np.linalg.norm(u)
        return u * (args.vmax / n) if n > args.vmax else u

    n_nav = int(args.nav_T / tick_T)
    run_phase(n_nav, nav_control)
    nav_true = np.array(true_path[n_exp:])
    dist_to_goal = np.linalg.norm(nav_true - goal[None], axis=1)
    est_err = np.linalg.norm(
        np.array(true_path) - np.array(est_path), axis=1)

    lat_ms = 1e3 * np.asarray(lat[1:])   # drop the first (residual warmup)
    result = {
        "metric": "closed-loop goto-goal (true distance to goal, m)",
        "final_dist": round(float(dist_to_goal[-1]), 4),
        "min_dist": round(float(dist_to_goal.min()), 4),
        "reached_0p15": bool(dist_to_goal.min() < 0.15),
        "explore_est_err_median": round(float(np.median(explore_err)), 4),
        "nav_est_err_median": round(float(np.median(est_err[n_exp:])), 4),
        "tick_steps": args.tick_steps,
        "tick_latency_ms_median": round(float(np.median(lat_ms)), 2),
        "tick_latency_ms_p90": round(float(np.percentile(lat_ms, 90)), 2),
        "control_rate_hz": round(1e3 / float(np.median(lat_ms)), 1),
        "realtime_factor": round(
            args.tick_steps * dt * 1e3 / float(np.median(lat_ms)), 2),
        "n_ticks": len(lat),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
