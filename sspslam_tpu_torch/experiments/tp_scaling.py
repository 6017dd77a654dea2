"""Tensor-parallel scaling probe: the full SLAM learning step sharded over
a model axis of 1, 2, 4, ... ranks on real devices.

Port of the JAX package's ``experiments/tp_scaling.py``.  For each world
size it starts that many ranks (``parallel.sharding.spawn``: NCCL on one
card each; gloo with ``--device cpu``), builds the JAX tool's SLAM world
with the Simulator sharded over the ranks, and prints one JSON row:

- the median milliseconds of a ``--steps``-step segment (after a warm-up
  segment that captures the CUDA graphs), over ``--reps`` segments; one
  rank runs the unsharded Simulator, the baseline;
- the all-reduces a step and their kB a step (the sharded step's own
  record of the collectives it issued);
- per-rank parameter and state bytes, and per-rank FLOPs, counted from the
  shard shapes (``parallel.dryrun.rank_cost``), each beside 1/n of the
  one-rank build's.

A world size larger than the number of cards raises; nothing is skipped.
The JAX tool's virtual-mesh caveats and ``--tpu-solve`` are not carried.

    python -m sspslam_tpu_torch.experiments.tp_scaling [--mesh-sizes 1,2,4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["build_slam", "main"]


def build_slam(args, device, mesh=None):
    """The JAX tool's world: a (0.6 sin 2t, 0.6 cos 3t) path, uniform
    landmarks in [-0.5, 0.5], SLAMNetwork at the given widths with a 30 x
    30 clean-up bank, the PI output probed through 50 ms."""
    from ..models import SLAMNetwork, get_slam_input_functions
    from ..nef import Connection, Network, Node, Probe, Simulator
    from ..sspspace import HexagonalSSPSpace, SPSpace
    dt, seed = 0.001, 0
    rng = np.random.default_rng(seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    n_steps = args.steps * (args.reps + 1) + 10
    ts = dt * np.arange(n_steps)
    path = 0.6 * np.stack([np.sin(2 * ts), np.cos(3 * ts)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = rng.uniform(-0.5, 0.5, size=(args.n_landmarks, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=seed)
    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.8)
    ssp0 = space.encode(path[:1]).flatten()
    with Network(seed=seed) as net:
        vel = Node(velocity_func)
        init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(space, lm_space, 0.8, args.n_landmarks,
                           pi_n_neurons=args.pi_n_neurons,
                           mem_n_neurons=args.mem_n_neurons,
                           circonv_n_neurons=args.circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=30, seed=seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        Probe(slam.pathintegrator.output, synapse=0.05)
    return Simulator(net, seed=seed, device=device, mesh=mesh)


def _rank(rank, world, device, args):
    from ..parallel.dryrun import rank_cost
    from ..parallel.sharding import make_mesh
    # one rank is the unsharded Simulator: the baseline the others scale
    sim = build_slam(args, device, mesh=make_mesh(world) if world > 1
                     else None)
    sim.preload_inputs(args.steps * (args.reps + 1))
    sim.run_steps(args.steps)            # warm-up: captures the graphs
    sim.sync()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        sim.run_steps(args.steps)
        sim.sync()
        times.append(time.perf_counter() - t0)
    cost = rank_cost(sim)
    return {"ms": [1e3 * t for t in times], "stats": sim.mesh_stats(),
            "cost": cost, "n_neurons": int(sum(
                be.k * be.n if be.batched else be.n
                for be in sim.model.ensembles))}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ssp-dim", type=int, default=55)
    ap.add_argument("--pi-n-neurons", type=int, default=200)
    ap.add_argument("--mem-n-neurons", type=int, default=400)
    ap.add_argument("--circonv-n-neurons", type=int, default=50)
    ap.add_argument("--n-landmarks", type=int, default=8)
    ap.add_argument("--mesh-sizes", default="1,2,4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--json-out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    from ..parallel.sharding import spawn
    sizes = [int(x) for x in args.mesh_sizes.split(",")]
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if max(sizes) > have:
            raise RuntimeError(f"tp_scaling: mesh sizes {sizes} but {have} "
                               f"cards")
    rows, base = [], None
    for n in sizes:
        res = spawn(_rank, n, args.device, args=(args,),
                    timeout=args.timeout,
                    threads=1 if args.device == "cpu" else None)
        r0 = res[0]
        cost = r0["cost"]
        if base is None:
            base = {k: v * sizes[0] for k, v in cost.items()}
        row = {"metric": "tp scaling, SLAM step sharded over a model axis",
               "mesh": n, "device": args.device,
               "neurons": r0["n_neurons"], "steps_per_segment": args.steps,
               "median_ms_per_segment": float(np.median(r0["ms"])),
               "ms_per_segment": r0["ms"],
               "all_reduces_per_step": r0["stats"]["all_reduces"],
               "all_reduce_kb_per_step": r0["stats"]["bytes"] / 1024,
               "param_bytes_per_rank": cost["param_bytes"],
               "state_bytes_per_rank": cost["state_bytes"],
               "flops_per_rank": cost["flops"],
               "param_bytes_vs_ideal": cost["param_bytes"]
               / (base["param_bytes"] / n),
               "state_bytes_vs_ideal": cost["state_bytes"]
               / (base["state_bytes"] / n),
               "flops_vs_ideal": cost["flops"] / (base["flops"] / n)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
