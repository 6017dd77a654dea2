"""Multi-device dry run: the full SLAM learning step sharded over N ranks.

Port of the JAX package's ``__graft_entry__.dryrun_multichip``.  It starts
N ranks (:func:`.sharding.spawn`: NCCL on ``cuda:{rank}``, gloo with
``--device cpu``) and on tiny shapes (ssp_dim 31, 48 / 64 / 16 neurons):

- shards SLAMNetwork (VCO bank, neuron axes, learned weights, clean-up
  bank) over a "model" axis of N and runs real steps: 8 steps, then 8
  more from a preloaded table as one chained run; every batched
  EnsembleArray's element axis must divide N; the probe rows must be
  finite and equal on every rank;
- counts per-rank FLOPs and bytes from the shard shapes (the encoders'
  and decoders' matrix-vector products, 2 FLOPs a multiply-add, as
  ``experiments/step_roofline.py`` counts them; parameters and state at
  their stored dtype): the per-rank FLOPs over 1/N of the unsharded
  build's must stay under 3.0 (the JAX dry run's bound on XLA's cost
  analysis);
- trains every solved decoder the step reads with ``fit`` on a "data"
  axis of N (one episode a rank), two Adam steps: the leaves must move;
- saves a serving bundle of that sharded Simulator (one program a
  model coordinate) and serves one 4-step segment of zero rows from it
  with ``ServingModel`` on every rank: the rows must be finite and the
  same on every rank (the JAX dry run's bundle step);
- with N >= 4 (even), runs dp x tp episodes on a (2, N/2) mesh.

    python -m sspslam_tpu_torch.parallel.dryrun --world N [--device cpu]

More CUDA ranks than cards raise.  Prints one JSON line; exits 0 when
every check holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["build_tiny_slam", "rank_cost", "main"]


def build_tiny_slam(ssp_dim=31, pi_n_neurons=48, mem_n_neurons=64,
                    circonv_n_neurons=16, n_landmarks=3, T=0.02, seed=0,
                    device="cpu", mesh=None):
    """The JAX dry run's SLAM (``_build_sim``): a circular path of T s,
    random landmarks, SLAMNetwork with a 20 x 20 clean-up bank, the PI
    output probed through 50 ms.  Returns (simulator, probe)."""
    from ..models import SLAMNetwork, get_slam_input_functions
    from ..nef import Connection, Network, Node, Probe, Simulator
    from ..sspspace import HexagonalSSPSpace, SPSpace
    dt = 0.001
    n_steps = int(T / dt)
    rng = np.random.default_rng(seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=ssp_dim, seed=seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    ts = dt * np.arange(n_steps)
    path = 0.6 * np.stack([np.sin(2 * np.pi * ts / T),
                           np.cos(2 * np.pi * ts / T)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = rng.uniform(-0.5, 0.5, size=(n_landmarks, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = SPSpace(n_landmarks, d, seed=seed)
    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.8)
    real0 = space.encode(path[:1]).flatten()
    with Network(seed=seed) as net:
        vel = Node(velocity_func)
        init = Node(lambda t: real0 if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(space, lm_space, 0.8, n_landmarks,
                           pi_n_neurons=pi_n_neurons,
                           mem_n_neurons=mem_n_neurons,
                           circonv_n_neurons=circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=20, seed=seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p = Probe(slam.pathintegrator.output, synapse=0.05)
    return Simulator(net, seed=seed, device=device, mesh=mesh), p


def _numel(x) -> int:
    return int(x.q.numel()) if hasattr(x, "q") else int(x.numel())


def _bytes(tree) -> int:
    from ..nef.steploop import flatten
    return int(sum(x.numel() * x.element_size() for x in flatten(tree)
                   if torch.is_tensor(x)))


def rank_cost(sim) -> dict:
    """This rank's work a step, counted from the shapes it holds: FLOPs
    (2 x the multiply-adds of every encoder and decoder product the step
    runs: the encoders, each decode's matrix or its group's stack, the
    learned decoders and encoders) and the bytes of its parameters and of
    its state."""
    from ..nef.executor import _ea_batch_decode_groups, _elem_decode_groups
    model, params = sim.model, sim.params
    macs = sum(_numel(e["scaled_encoders"]) for e in params["ens"])
    grouped = {bc.index for gs in (_elem_decode_groups(model),
                                   _ea_batch_decode_groups(model))
               for bcs in gs.values() for bc in bcs}
    macs += sum(_numel(v) for v in params["dstack"].values())
    for bc in model.connections:
        if bc.index in grouped or bc.decoders is None:
            continue
        if bc.learned_slot is not None:
            if bc.learned_slot.startswith("pes"):
                macs += _numel(sim.state["learned"][bc.learned_slot])
        else:
            macs += _numel(params["conn"][str(bc.index)]["D"])
    for be in model.ensembles:
        if be.voja_conn_index is not None:   # the learned encoders
            macs += _numel(sim.state["learned"][f"voja_{be.voja_conn_index}"])
    return {"flops": 2 * macs, "param_bytes": _bytes(params),
            "state_bytes": _bytes(sim.state)}


def _bundle_step(sim, mesh, device) -> dict:
    """The sharded serving bundle of ``sim`` (saved by every rank into one
    temporary directory, 4-step segments), served by ``ServingModel`` on
    every rank for one segment of zero rows: the rows must be finite and
    the same on every rank."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from ..nef import ServingModel, save_bundle
    from .sharding import assert_same_on_ranks
    where = [tempfile.mkdtemp(prefix="sspslam_dryrun_bundle_")
             if mesh.rank == 0 else None]
    dist.broadcast_object_list(where, 0)
    try:
        save_bundle(sim, where[0], segment_steps=4)
        m = ServingModel(where[0], device=device)
        emits = m.step_segment(np.zeros((4, m.input_width), np.float32))
        rows = [v.cpu() for v in emits.values()]
        assert rows and all(bool(torch.isfinite(v).all()) for v in rows)
        assert_same_on_ranks(rows, None, "the served rows")
        mm = m.meta["mesh"]
        return {"programs": len(mm["programs"]),
                "all_reduces_per_step": mm["all_reduces_per_step"],
                "rows": list(rows[0].shape)}
    finally:
        dist.barrier()
        if mesh.rank == 0:
            shutil.rmtree(where[0], ignore_errors=True)


def _rank(rank, world, device):
    from ..nef.graph import EnsembleArray
    from .. import train
    from ..nef.executor import _ea_batch_decode_groups, _elem_decode_groups
    from .sharding import assert_same_on_ranks, make_mesh
    from .trials import run_batched_episodes
    out = {}
    # the SLAM learning step over a model axis of `world`
    mesh = make_mesh(world)
    sim, p = build_tiny_slam(device=device, mesh=mesh)
    for be in sim.model.ensembles:
        obj = be.obj[0] if isinstance(be.obj, tuple) else be.obj
        if world > 1 and be.batched and isinstance(obj, EnsembleArray):
            assert be.k % world == 0, (be.k, world)
    sim.run_steps(8)
    sim.preload_inputs(8)
    sim.run_steps(8, segment_steps=4, chain=True)
    rows = sim.data[p]
    assert rows.shape[0] == 16 and np.all(np.isfinite(rows)), rows.shape
    assert_same_on_ranks([torch.as_tensor(rows)], mesh.group("model"),
                         "the probe rows")
    out["rows"] = rows.shape
    out["mesh_stats"] = sim.mesh_stats()
    out["bundle"] = _bundle_step(sim, mesh, device)
    cost = rank_cost(sim)
    single, _ = build_tiny_slam(device=device)
    whole = rank_cost(single)
    out["flops_rank"], out["flops_single"] = cost["flops"], whole["flops"]
    out["flops_ratio"] = cost["flops"] / (whole["flops"] / world)
    out["bytes_ratio"] = ((cost["param_bytes"] + cost["state_bytes"])
                          / ((whole["param_bytes"] + whole["state_bytes"])
                             / world))
    assert out["flops_ratio"] < 3.0, out["flops_ratio"]
    del sim, single

    # data-parallel fit: one episode a rank, the solved decoders trained
    mesh_dp = make_mesh(world, ("data",))
    sim_t, p_t = build_tiny_slam(device=device)
    n_t = 8
    ep = train.make_batched_episode_fn(sim_t, n_t, segment_steps=4)
    xs1 = train.episode_inputs(sim_t, n_t)
    xs_b = np.broadcast_to(xs1, (world,) + xs1.shape).copy()
    pidx = train.probe_index(sim_t, p_t)
    dead = {bc.index for gs in (_elem_decode_groups(sim_t.model),
                                _ea_batch_decode_groups(sim_t.model))
            for bcs in gs.values() for bc in bcs}
    live = {f"conn/{bc.index}/D" for bc in sim_t.model.connections
            if bc.decoders is not None and bc.learned_slot is None
            and bc.index not in dead}
    before, _ = train.partition_params(sim_t.params, live.__contains__)
    params_fit, losses = train.fit(
        ep, sim_t.params, xs_b, train.batched_initial_state(sim_t, world),
        lambda emits, final: torch.mean(emits[pidx] ** 2),
        trainable=live.__contains__,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3), steps=2,
        mesh=mesh_dp)
    after, _ = train.partition_params(params_fit, live.__contains__)
    moved = any(not torch.allclose(a, b) for (_, a), (_, b) in zip(
        train._leaves_with_paths(before), train._leaves_with_paths(after))
        if a is not None)
    assert len(losses) == 2 and np.all(np.isfinite(losses)), losses
    assert moved, "the data-parallel fit moved no trainable leaf"
    out["fit_losses"] = losses

    if world >= 4 and world % 2 == 0:
        mesh2 = make_mesh(world, ("data", "model"), (2, world // 2))
        sim2, p2 = build_tiny_slam(device=device, mesh=mesh2)
        tables = [np.broadcast_to(c[:8], (2,) + c[:8].shape).copy()
                  for c in sim2._tabulate_inputs(8)]
        res, _ = run_batched_episodes(sim2, tables, 8, mesh=mesh2)
        v = res[p2]
        assert v.shape[:2] == (2, 8) and np.all(np.isfinite(v)), v.shape
        out["dp_tp_rows"] = v.shape
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; 1 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    from .sharding import spawn
    world = args.world
    if world is None:
        world = torch.cuda.device_count() if args.device == "cuda" else 1
    t0 = time.perf_counter()
    res = spawn(_rank, world, args.device, timeout=args.timeout,
                threads=1 if args.device == "cpu" else None)
    r0 = res[0]
    row = {"metric": "multi-device dry run", "world": world,
           "device": args.device, "rows": list(r0["rows"]),
           "all_reduces_per_step": r0["mesh_stats"]["all_reduces"],
           "all_reduce_bytes_per_step": r0["mesh_stats"]["bytes"],
           "flops_per_rank": r0["flops_rank"],
           "flops_unsharded": r0["flops_single"],
           "flops_ratio_to_ideal": r0["flops_ratio"],
           "bytes_ratio_to_ideal": r0["bytes_ratio"],
           "fit_losses": r0["fit_losses"],
           "dp_tp_rows": list(r0.get("dp_tp_rows", ())),
           "bundle": r0["bundle"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main(sys.argv[1:])
