"""Online multi-agent mapping on the port: two agents step CONCURRENTLY
as batched episodes (``parallel.BatchedEpisodes``) with periodic map
exchange.  The protocol, flags, printed lines and JSON keys of the JAX
package's ``experiments/live_merge.py``, with ``--device`` (default
``cuda``) in place of ``--cpu``.

Both agents advance in one batched step and, every ``--exchange-s``
seconds of simulated time, their learned maps (PES decoders and Voja
encoders, leaves of the batched state) are fused on the device and
written back into both episodes:

    M_k = A + B - M_{k-1}

(deltas since the previous exchange add, as map_merge's offline
arithmetic).  The fused leaf is written IN PLACE into the state tensors
the batched episodes' CUDA graphs read, between segments.

Agent A explores the LEFT half for the first two thirds of the run, then
crosses into the RIGHT half (B mirror-image).  In the crossover each agent
enters territory only the OTHER agent has mapped: with exchange on the
recalled landmarks are familiar; with it off (control) the same crossing
runs on path integration and its own half-map.

    python -m sspslam_tpu_torch.experiments.live_merge [--T 120] \
        [--exchange-s 5] [--device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..models import SLAMNetwork, get_slam_input_functions2
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..nef.processes import TimeTable, clamp_table
from ..nef.simulator import _host
from ..parallel import BatchedEpisodes
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.sampling import Rd_sampling
from .common import DT, decode_output, learned_base


def make_crossover_path(T, dt, limit, seed, start_side):
    """Phase 1 (2/3 of T): fill one half; phase 2: fill the other."""
    n = int(T / dt)
    n1 = (2 * n) // 3
    segs = []
    for i, (steps, side) in enumerate(((n1, start_side),
                                       (n - n1, -start_side))):
        Tseg = steps * dt
        p = np.hstack([
            WhiteSignal(Tseg, high=limit, seed=seed + 31 * i + j).run(
                Tseg, dt=dt) for j in range(2)])[:steps]
        x_lo, x_hi = ((-0.9, -0.05) if side < 0 else (0.05, 0.9))
        for j, (lo_t, hi_t) in enumerate(((x_lo, x_hi), (-0.9, 0.9))):
            lo, hi = p[:, j].min(), p[:, j].max()
            p[:, j] = (p[:, j] - lo) / max(hi - lo, 1e-12) \
                * (hi_t - lo_t) + lo_t
        segs.append(p)
    # join continuously with a linear ramp whose speed matches the explore
    # phase's p90 speed: the model bakes one velocity scale over the whole
    # path, and a fast bridge would compress every agent's explore-phase
    # drive into the path integrator's low-SNR regime
    a, b = segs
    va = np.linalg.norm(np.diff(a, axis=0), axis=1) / dt
    v_ref = max(float(np.percentile(va, 90)), 1e-3)
    dist = float(np.linalg.norm(b[0] - a[-1]))
    bridge_steps = max(int(1.0 / dt), int(dist / v_ref / dt))
    ramp = np.linspace(0, 1, bridge_steps)[:, None]
    bridge = a[-1] * (1 - ramp) + b[0] * ramp
    return np.concatenate([a, bridge, b])[:n]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--T", type=float, default=120.0)
    ap.add_argument("--exchange-s", type=float, default=5.0,
                    help="map-exchange period (simulated seconds); also "
                         "the segment length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--a-path-seed", type=int, default=None,
                    help="override agent A's trajectory seed while keeping "
                         "the world (landmarks/space/SP draws) at --seed — "
                         "isolates path-vs-world attribution when a seed "
                         "fails phase A (diagnostic)")
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--n-landmarks", type=int, default=50)
    ap.add_argument("--view-rad", type=float, default=0.2)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--length-scale", type=float, default=0.2)
    ap.add_argument("--update-thres", type=float, default=0.4)
    ap.add_argument("--shift-rate", type=float, default=0.1)
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--pes-lr", type=float, default=2e-2)
    ap.add_argument("--intercept", type=float, default=0.3)
    ap.add_argument("--probe-every", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    return ap.parse_args(argv)


def build(args):
    """The two agents' paths and (T, B, size) input tables, the space and
    the Simulator of the shared model (its PI output probed).  Returns a
    dict: ``paths``, ``space``, ``sim``, ``probe``, ``tables`` (in
    ``sim.model.input_nodes`` order) and ``n_steps``."""
    dt = DT
    n_steps = int(args.T / dt)
    radius = 1.0
    a_seed = args.seed if args.a_path_seed is None else args.a_path_seed
    paths = [make_crossover_path(args.T, dt, args.limit, a_seed, -1),
             make_crossover_path(args.T, dt, args.limit, args.seed + 500,
                                 +1)]
    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=args.length_scale,
                              domain_bounds=bounds)
    d = space.ssp_dim
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, 2, seed=args.seed) - 0.5)
    lm_space = SPSpace(args.n_landmarks, d, seed=args.seed)

    # one velocity scale shared by both agents (baked into the model)
    vels = [(1 / dt) * np.diff(p, axis=0, prepend=p[:1]) for p in paths]
    A_mat = space.phase_matrix
    shared_scale = 1.0 / max(float(np.abs(A_mat @ v.T).max()) for v in vels)

    def agent_tables(path, v):
        vec_to_lm = obj_locs[None, :, :] - path[:, None, :]
        (_, _, in_view_f, _, sp_f, _, vecssp_f) = \
            get_slam_input_functions2(space, lm_space, v, vec_to_lm,
                                      args.view_rad)
        return {
            "vel": (v * shared_scale).astype(np.float32),
            "init": clamp_table(space.encode(path[:1]).flatten(), 0.05,
                                dt).rows(0, n_steps),
            "lm_sp": sp_f.rows(0, n_steps),
            "lm_vecssp": vecssp_f.rows(0, n_steps),
            "in_view": in_view_f.rows(0, n_steps),
        }

    t0 = time.time()
    tabs = [agent_tables(p, v) for p, v in zip(paths, vels)]
    print(f"worlds: built in {time.time() - t0:.1f}s", flush=True)

    node_key = {}
    with Network(seed=args.seed) as net:
        t0w = tabs[0]
        vel = Node(TimeTable(t0w["vel"], dt))
        init = Node(TimeTable(t0w["init"], dt))
        lm_id = Node(TimeTable(t0w["lm_sp"], dt))
        lm_ssp = Node(TimeTable(t0w["lm_vecssp"], dt))
        in_view = Node(TimeTable(t0w["in_view"], dt))
        for node, key in ((vel, "vel"), (init, "init"), (lm_id, "lm_sp"),
                          (lm_ssp, "lm_vecssp"), (in_view, "in_view")):
            node_key[id(node)] = key
        slam = SLAMNetwork(
            space, lm_space, args.view_rad, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons, args.circonv_n_neurons,
            update_thres=args.update_thres, shift_rate=args.shift_rate,
            voja_learning_rate=args.voja_lr, pes_learning_rate=args.pes_lr,
            intercept=args.intercept, vel_scaling_factor=shared_scale,
            seed=args.seed, gate_mode="auto_recovery")
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p_out = Probe(slam.pathintegrator.output, synapse=0.05)

    sim = Simulator(net, seed=args.seed, device=args.device)
    n_neurons = sum((b.k * b.n if b.batched else b.n)
                    for b in sim.model.ensembles)
    print(f"model built: {n_neurons:,} LIF neurons", flush=True)
    tables = [np.stack([t[node_key[id(n)]] for t in tabs], axis=1)
              for n in sim.model.input_nodes]
    return dict(paths=paths, space=space, sim=sim, probe=p_out,
                tables=tables, n_steps=n_steps)


def exchange(runner, base):
    """Fuse both episodes' learned maps on the device, M = A + B - M_prev,
    and write M in place into both episodes' state (the tensors the
    batched graphs read); ``base`` becomes M."""
    for k, leaf in runner.state["learned"].items():
        m = leaf[0] + leaf[1] - base[k]
        leaf.copy_(m.expand_as(leaf))
        base[k] = m


def run_arm(built, seg, per, do_exchange):
    """One arm: both agents from the model's initial state, segments of
    ``seg`` steps, an exchange after every segment but the last when
    ``do_exchange``.  Returns the PI output every ``per`` steps, (B,
    samples, d) on the host, and the wall seconds."""
    sim, n_steps = built["sim"], built["n_steps"]
    p_idx = next(bp.index for bp in sim.model.probes
                 if bp.obj is built["probe"])
    runner = BatchedEpisodes(sim, built["tables"])
    base = learned_base(sim)
    kept = []
    done = 0
    t0 = time.time()
    while done < n_steps:
        hi = min(done + seg, n_steps)
        emits = runner.run(hi - done)
        phase = (per - 1 - done % per) % per
        kept.append(emits[p_idx][phase::per].clone())
        if do_exchange and hi < n_steps:
            exchange(runner, base)
        done = hi
    runner.sync()
    wall = time.time() - t0
    out = np.swapaxes(_host(torch.cat(kept)), 0, 1)   # (B, samples, d)
    return out, wall


def main(argv=None):
    args = parse_args(argv)
    dt = DT
    built = build(args)
    paths, space, n_steps = built["paths"], built["space"], built["n_steps"]
    B = len(paths)
    n_cross = n_steps - (2 * n_steps) // 3   # crossover phase length
    seg = max(1, int(args.exchange_s / dt))
    per = max(1, int(round(args.probe_every / dt)))

    results = {}
    for label, do_x in (("exchange", True), ("no_exchange", False)):
        out, wall = run_arm(built, seg, per, do_x)
        k = out.shape[1]
        row = {"wall_s": round(wall, 1),
               "agg_steps_per_s": round(B * n_steps / wall, 1)}
        for b in range(B):
            path_s = paths[b][per - 1::per][:k]
            est = decode_output(space, out[b], 2, grid=100,
                                device=args.device)
            err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
            n_cross_s = max(1, n_cross // per)
            cross = err[-n_cross_s:]
            row[f"agent_{'AB'[b]}"] = {
                "explore_median": round(float(
                    np.median(err[:-n_cross_s])), 4),
                "cross_median": round(float(np.median(cross)), 4),
                "cross_p90": round(float(np.quantile(cross, 0.9)), 4),
            }
        results[label] = row
        print(json.dumps({label: row}), flush=True)

    out_line = {
        "metric": "live two-agent mapping: crossover-phase median error "
                  "(each agent localizing in territory only the other "
                  "mapped), exchange vs none",
        "exchange_s": args.exchange_s, "T": args.T,
        "ssp_dim": space.ssp_dim, "seed": args.seed,
        "value": round(float(np.mean(
            [results["exchange"][f"agent_{a}"]["cross_median"]
             for a in "AB"])), 4),
        "unit": "arena units",
        "results": results,
    }
    print(json.dumps(out_line))
    return out_line


if __name__ == "__main__":
    main()
