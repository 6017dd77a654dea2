"""Loop-closure equilibrium tuning sweep on the port: the protocol, grids
and printed lines of the JAX package's ``experiments/tune_loop_closure.py``
(``make_world``, ``build_sim``, ``run_config`` and its CLI), with
``--device`` (default ``cuda``) in place of ``--cpu``.

Sweeps (update_thres, shift_rate, pes_lr, voja_lr, intercept) on one world
with no recapture: the gate's thresholds are hoisted tables and the PES /
Voja learning rates 0-d tensors of ``sim.params``, so a configuration
that differs from the last only in those is written into the params in
place and replayed through the same CUDA graphs.  An intercept changes
gains, biases and every decoder solved over them (and the Voja encoders'
initial state), so each intercept gets one built simulator; the world's
input table is preloaded on the device once per simulator.

Stage 1 sweeps the gate (update_thres x shift_rate) at --T; stage 2 refines
the best gate setting over (pes_lr, voja_lr, intercept); stage 3 confirms
the best rows at --final-T.

    python -m sspslam_tpu_torch.experiments.tune_loop_closure [--T 50] \
        [--final-T 200] [--quick] [--device cpu]
"""

import argparse
import itertools
import time

import numpy as np

from .. import train
from ..models import SLAMNetwork, get_slam_input_functions2
from ..nef import Connection, Network, Node, Probe, Simulator, WhiteSignal
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.sampling import Rd_sampling
from .common import decode_output


def make_world(T, seed, limit=0.1, n_landmarks=50, view_rad=0.2,
               ssp_dim=97, radius=1.0):
    # guard against a degenerate world: WhiteSignal needs at least one
    # frequency bin under the cutoff (high >= 1/T)
    limit = max(limit, 1.5 / T)
    dt = 0.001
    n_steps = int(T / dt)
    path = np.hstack([
        WhiteSignal(T, high=limit, seed=seed + i).run(T, dt=dt)
        for i in range(2)])[:n_steps]
    for i in range(2):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * 1.8 * radius - 0.9 * radius)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    bounds = 1.1 * radius * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=ssp_dim, seed=seed,
                              length_scale=0.2, domain_bounds=bounds)
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(n_landmarks, 2, seed=seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]
    lm_space = SPSpace(n_landmarks, space.ssp_dim, seed=seed)
    fns = get_slam_input_functions2(space, lm_space, vels, vec_to_landmarks,
                                    view_rad)
    return dict(space=space, lm_space=lm_space, path=path, vels=vels,
                fns=fns, n_steps=n_steps, view_rad=view_rad,
                n_landmarks=n_landmarks)


def build_sim(world, cfg, seed, pi_n=800, mem_n=970, cc_n=100,
              **sim_kwargs):
    """The world's SLAMNetwork with ``cfg``'s loop-closure settings, its PI
    output probed through a 50 ms lowpass; ``sim_kwargs`` go to the
    Simulator (``device=``, ``default_neuron_type=``)."""
    space, lm_space = world["space"], world["lm_space"]
    d = space.ssp_dim
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = world["fns"]
    init = space.encode(world["path"][:1]).flatten()
    with Network(seed=seed) as net:
        vel = Node(vel_f)
        init_node = Node(lambda t: init if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(space, lm_space, world["view_rad"],
                           world["n_landmarks"], pi_n, mem_n, cc_n,
                           update_thres=cfg["update_thres"],
                           shift_rate=cfg["shift_rate"],
                           voja_learning_rate=cfg["voja_lr"],
                           pes_learning_rate=cfg["pes_lr"],
                           intercept=cfg["intercept"],
                           vel_scaling_factor=scale, seed=seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init_node, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p = Probe(slam.pathintegrator.output, synapse=0.05)
    sim = Simulator(net, seed=seed, **sim_kwargs)
    return sim, p


def slam_of(sim):
    """The SLAMNetwork of ``sim``'s network."""
    return next(n for n in sim.model.network.networks
                if isinstance(n, SLAMNetwork))


def configure(sim, cfg):
    """Write ``cfg``'s learning rates and gate scalars into ``sim.params``
    in place (the next run replays the same graphs)."""
    slam = slam_of(sim)
    lr = sim.params["hyper"]["lr"]
    for conn, key in ((slam.assomemory.conn_out, "pes_lr"),
                      (slam.assomemory.conn_in, "voja_lr")):
        lr[train.learning_rate_path(sim, conn).split("/")[-1]].fill_(cfg[key])
    gate = next(h for h in sim.params["hoisted"].values()
                if "shift_rate" in h)
    gate["update_thres"].fill_(cfg["update_thres"])
    gate["shift_rate"].fill_(cfg["shift_rate"])


def run_config(sim, probe, world, segment_steps=1000):
    """Run ``sim`` from its initial state over the world with its current
    params; returns the median, last-quarter median and final decoded
    distance errors.  The world's input table is preloaded on the device
    on the first run and kept across runs."""
    n_steps = world["n_steps"]
    sim.reset(keep_inputs=True)
    if sim._preloaded is None:
        sim.preload_inputs(n_steps)
    sim.run_steps(n_steps, segment_steps=segment_steps)
    out = sim.data[probe]
    skip = max(1, n_steps // 2000)
    path_s = world["path"][::skip]
    q = max(1, len(path_s) // 4)
    est = decode_output(world["space"], out[::skip], 2, grid=100,
                        device=sim.device)
    err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
    return float(np.median(err)), float(np.median(err[-q:])), float(err[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=50.0,
                    help="stage-1 episode length")
    ap.add_argument("--final-T", type=float, default=200.0,
                    help="stage-2 episode length (reference protocol)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segment-steps", type=int, default=1000)
    ap.add_argument("--top", type=int, default=3)
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--view-rad", type=float, default=0.2)
    ap.add_argument("--limit", type=float, default=0.1)
    ap.add_argument("--n-landmarks", type=int, default=50)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--quick", action="store_true",
                    help="trimmed grids (2x2 gate, 2 refinements, top-1 "
                         "confirmation) — smoke tests")
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on (cuda | cpu)")
    args = ap.parse_args(argv)

    base = dict(update_thres=0.2, shift_rate=0.2, voja_lr=1e-4,
                pes_lr=5e-3, intercept=0.1)

    world = make_world(args.T, args.seed, n_landmarks=args.n_landmarks,
                       ssp_dim=args.ssp_dim, view_rad=args.view_rad,
                       limit=args.limit)
    sims = {}        # intercept -> (simulator, probe) on the current world
    results = []

    def evaluate(cfg, world, tag):
        t0 = time.time()
        if cfg["intercept"] not in sims:
            sims[cfg["intercept"]] = build_sim(
                world, cfg, args.seed, pi_n=args.pi_n_neurons,
                mem_n=args.mem_n_neurons, cc_n=args.circonv_n_neurons,
                device=args.device)
        sim, p = sims[cfg["intercept"]]
        configure(sim, cfg)
        med, lq, fin = run_config(sim, p, world,
                                  segment_steps=args.segment_steps)
        print(f"[{tag}] thr={cfg['update_thres']:.2f} "
              f"sr={cfg['shift_rate']:.2f} pes={cfg['pes_lr']:.0e} "
              f"voja={cfg['voja_lr']:.0e} icpt={cfg['intercept']:.2f} "
              f"-> median {med:.3f}, last-q {lq:.3f}, final {fin:.3f} "
              f"({time.time() - t0:.0f}s)", flush=True)
        results.append((med, lq, cfg))
        return med

    # stage 1: gate grid
    thr_grid = [0.1, 0.4] if args.quick else [0.05, 0.1, 0.2, 0.4]
    sr_grid = [0.1, 0.5] if args.quick else [0.1, 0.2, 0.5, 1.0]
    for thr, sr in itertools.product(thr_grid, sr_grid):
        cfg = dict(base, update_thres=thr, shift_rate=sr)
        evaluate(cfg, world, "s1")

    results.sort(key=lambda r: r[0])
    best_gate = results[0][2]
    print(f"\nbest gate: thr={best_gate['update_thres']} "
          f"sr={best_gate['shift_rate']}")

    # stage 2: learning/intercept refinements around the best gate
    stage2 = []
    pes_grid = [5e-3, 2e-2] if args.quick else [5e-3, 1e-2, 2e-2]
    voja_grid = [1e-4] if args.quick else [1e-4, 5e-4]
    icpt_grid = [0.1] if args.quick else [0.1, 0.3]
    for pes, voja, icpt in itertools.product(pes_grid, voja_grid,
                                             icpt_grid):
        cfg = dict(best_gate, pes_lr=pes, voja_lr=voja, intercept=icpt)
        med = evaluate(cfg, world, "s2")
        stage2.append((med, cfg))

    stage2.sort(key=lambda r: r[0])
    print("\n== stage-2 ranking (top 5) ==")
    for med, cfg in stage2[:5]:
        print(f"  {med:.3f}  {cfg}")

    # stage 3: confirm the best configs at the full reference protocol
    world_f = make_world(args.final_T, args.seed,
                         n_landmarks=args.n_landmarks, ssp_dim=args.ssp_dim,
                         view_rad=args.view_rad, limit=args.limit)
    sims.clear()
    print(f"\n== stage-3 confirmation at T={args.final_T}s ==")
    for _, cfg in stage2[:args.top]:
        evaluate(cfg, world_f, "s3")
    evaluate(base, world_f, "s3-ref-defaults")


if __name__ == "__main__":
    main()
