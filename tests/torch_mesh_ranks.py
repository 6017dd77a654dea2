"""The networks of the mesh tests and the functions their ranks run.

Imported by the ranks that ``torch_parity.spawn_ranks`` starts, so it
imports the port, torch and NumPy only (no JAX): each rank builds its
network from the same arguments as every other rank.  The networks are
those of tests/test_parallel.py (the JAX package's mesh tests).
"""

import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from sspslam_tpu_torch.nef import ServingModel, save_bundle
from sspslam_tpu_torch.parallel.sharding import make_mesh

BOUNDS = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))


def lib(package):
    """The names the networks use, from ``package`` (the port here; the
    tests pass the JAX package to build the same networks there)."""
    root = importlib.import_module(package)
    return SimpleNamespace(sp=root, models=importlib.import_module(
        package + ".models"), nef=importlib.import_module(package + ".nef"))


PORT = lib("sspslam_tpu_torch")

#: the segment of the mesh tests' serving bundles
BUNDLE_SEGMENT = 10


def space(L, d=31):
    return L.sp.HexagonalSSPSpace(2, ssp_dim=d, seed=0, length_scale=0.3,
                                  domain_bounds=BOUNDS)


def pi_net(L=PORT, d=31, seed=0, n_neurons=80):
    """test_parallel.make_pi_net: PathIntegration (LIFRate) on a constant
    velocity from a clamped start, its output probed through 50 ms."""
    nef = L.nef
    sp = space(L, d)
    ssp0 = sp.encode(np.array([[0.1, -0.2]])).flatten()
    d = sp.ssp_dim
    with nef.Network(seed=seed) as net:
        vel = nef.Node(lambda t: np.array([0.1, 0.0]))
        init = nef.Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        pi = L.models.PathIntegration(sp, n_neurons, 0.05,
                                      neuron_type=nef.LIFRate())
        nef.Connection(vel, pi.velocity_input, synapse=None)
        nef.Connection(init, pi.input, synapse=None)
        p = nef.Probe(pi.output, synapse=0.05)
    return net, [p]


def anchored_slam_net(L=PORT, d=31, T=0.2):
    """test_parallel.TestAnchoredGateUnderMesh: SLAMNetwork with the
    auto-recovery gate and anchor beacons on a circular path; the PI
    output, the memory's neurons and its decoded value probed."""
    nef, models = L.nef, L.models
    sp = space(L, d)
    d = sp.ssp_dim
    dt = 0.001
    n_steps = int(T / dt)
    ts = dt * np.arange(n_steps)
    path = 0.4 * np.stack([np.sin(2 * np.pi * ts / T),
                           np.cos(2 * np.pi * ts / T)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.array([[0.2, 0.1], [-0.3, 0.3], [0.1, -0.4]])
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = L.sp.SPSpace(3, d, seed=0)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(sp, lm_space, vels, vec_to_lm, 0.8)
    pos_f, vec_f, iv_f = models.get_anchor_input_functions(
        sp, vec_to_lm, np.array([0, 1]), landmarks[:2], 0.8, dt=dt)
    ssp0 = sp.encode(path[:1]).flatten()
    with nef.Network(seed=0) as net:
        vel = nef.Node(vel_f)
        init = nef.Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        lm_id = nef.Node(sp_f)
        lm_ssp = nef.Node(vecssp_f)
        in_view = nef.Node(in_view_f)
        anc_pos, anc_vec, anc_iv = (nef.Node(pos_f), nef.Node(vec_f),
                                    nef.Node(iv_f))
        slam = models.SLAMNetwork(sp, lm_space, 0.8, 3,
                                  pi_n_neurons=64, mem_n_neurons=80,
                                  circonv_n_neurons=24,
                                  vel_scaling_factor=scale,
                                  cleanup_samples_per_dim=10, seed=0,
                                  gate_mode="auto_recovery", anchor=True,
                                  gate_kwargs={"anchor_trigger": 0.3})
        nef.Connection(vel, slam.velocity_input, synapse=None)
        nef.Connection(init, slam.pathintegrator.input, synapse=None)
        nef.Connection(lm_id, slam.landmark_id_input, synapse=None)
        nef.Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        nef.Connection(in_view, slam.no_landmark_in_view, synapse=None)
        nef.Connection(anc_pos, slam.anchor_pos_input, synapse=None)
        nef.Connection(anc_vec, slam.anchor_vec_ssp, synapse=None)
        nef.Connection(anc_iv, slam.no_anchor_in_view, synapse=None)
        p = nef.Probe(slam.pathintegrator.output, synapse=0.05)
        p_act = nef.Probe(slam.assomemory.memory.neurons)
        p_mem = nef.Probe(slam.assomemory.memory, synapse=0.01)
    return net, [p, p_act, p_mem]


def int8_net(L=PORT):
    """test_parallel.TestParamsShardings's quantised model: a 64-neuron,
    40-dimensional ensemble between two nodes."""
    nef = L.nef
    with nef.Network(seed=0) as net:
        src = nef.Node(lambda t: np.full(40, 0.3 * np.sin(20 * t)))
        ens = nef.Ensemble(64, 40, neuron_type=nef.LIFRate())
        out = nef.Node(size_in=40)
        nef.Connection(src, ens, synapse=None)
        nef.Connection(ens, out, synapse=0.01)
        p = nef.Probe(out)
    return net, [p]


def fused_net(L=PORT):
    """Four same-shaped LIFRate ensembles that the builder fuses into one
    k = 4 group (split over its elements at world 2 and 4), each decoded
    through a filter into one node, one's raw activities into another
    node in the same step; a decoded probe of one element and an
    activity probe of another."""
    nef = L.nef
    with nef.Network(seed=1) as net:
        src = nef.Node(lambda t: np.array([np.sin(10 * t), np.cos(7 * t),
                                           0.3]))
        out = nef.Node(size_in=3)
        raw = nef.Node(size_in=40)
        ens = [nef.Ensemble(40, 3, neuron_type=nef.LIFRate())
               for _ in range(4)]
        for i, e in enumerate(ens):
            nef.Connection(src, e, synapse=None)
            nef.Connection(e, out, synapse=0.01,
                           transform=0.25 * (i + 1) * np.eye(3))
        nef.Connection(ens[1].neurons, raw, synapse=None)
        probes = [nef.Probe(out), nef.Probe(raw),
                  nef.Probe(ens[2], synapse=0.02), nef.Probe(ens[3].neurons)]
    return net, probes


NETS = {"pi": pi_net, "slam": anchored_slam_net, "int8": int8_net,
        "fused": fused_net}


def sim_kwargs(name, L, spiking=False, **kw):
    """The Simulator arguments of network ``name``: the SLAM runs with
    LIFRate neurons unless ``spiking`` (LIF, the default type)."""
    if name == "slam" and not spiking:
        kw["default_neuron_type"] = L.nef.LIFRate()
    return kw


def build_sim(name, kw, mesh=None, device="cpu", spiking=False, **sim_kw):
    """The port's Simulator of network ``name`` (its builder's ``kw``) and
    its probes."""
    net, probes = NETS[name](**kw)
    sim = PORT.nef.Simulator(net, seed=0, device=device, mesh=mesh,
                             **sim_kwargs(name, PORT, spiking, **sim_kw))
    return sim, probes


def run_sharded(rank, world, device, name, kw, n_steps, sim_kw, ckpt=None,
                bundle=None):
    """Rank ``rank`` of a ``world``-way model axis: build ``name``, run
    ``n_steps`` (in two segments, a checkpoint between them when
    ``ckpt`` is given), and return every probe's trace, the collectives
    of a step and the layout's split axes.  ``bundle`` (with ``ckpt``): a
    directory the ranks save a serving bundle into before the run
    (segments of BUNDLE_SEGMENT steps), served after it
    (:func:`serve_bundle`)."""
    mesh = make_mesh(world)
    sim, probes = build_sim(name, kw, mesh=mesh, device=device, **sim_kw)
    half = n_steps // 2
    if bundle is not None:
        xs = sim._pack_cols(sim._tabulate_inputs(n_steps))
        save_bundle(sim, bundle, segment_steps=BUNDLE_SEGMENT)
    sim.run_steps(half)
    if ckpt is not None:
        sim.save_checkpoint(ckpt)
    sim.run_steps(n_steps - half)
    whole = sim.whole_state()
    out = {"traces": [sim.data[p] for p in probes],
           "stats": sim.mesh_stats(),
           "final_state": _host_tree(whole)}
    if bundle is not None:
        out["served"] = serve_bundle(rank, world, device, sim, probes,
                                     bundle, xs, ckpt, name, kw, sim_kw)
    if ckpt is not None:
        # a fresh sharded Simulator resumed from the file matches the run
        sim2, probes2 = build_sim(name, kw, mesh=mesh, device=device,
                                  **sim_kw)
        sim2.load_checkpoint(ckpt)
        sim2.run_steps(n_steps - half)
        out["resumed"] = [sim2.data[p] for p in probes2]
        sim2.reset()
        sim2.run_steps(half)
        out["after_reset"] = [sim2.data[p] for p in probes2]
    return out


def probe_labels(sim, probes, meta):
    """The bundle's label of each of ``probes``."""
    by_index = {d["index"]: d["label"] for d in meta["probes"]}
    return [by_index[next(bp.index for bp in sim.model.probes
                          if bp.obj is p)] for p in probes]


def serve_bundle(rank, world, device, sim, probes, bundle, xs, ckpt, name,
                 kw, sim_kw):
    """The sharded bundle in ``bundle`` (saved from ``sim``'s fresh state)
    served on every rank: the first half of ``xs`` from the bundle's
    state; ``reset`` and the first segment again; ``load_state`` of the
    half-way checkpoint ``ckpt`` and the second half (both from a state
    they must replace); the all-reduces in this rank's program; a serving
    world of another size refused.  One rank a network (rank 0 for "pi",
    the last for the others) also returns the arrays of an unsharded
    bundle of the same build (the builder padding batched groups to
    ``world``, as the sharded build does)."""
    m = ServingModel(bundle, device=device)
    labels = probe_labels(sim, probes, m.meta)
    half = len(xs) // 2
    mm = m.meta["mesh"]
    first = _rows(m.run(xs[:half]), labels)
    m.reset()
    out = {"after_reset": _rows(m.run(xs[:BUNDLE_SEGMENT]), labels),
           "meta_mesh": mm,
           "groups": (mm["group_name"], m.mesh.group("model").group_name),
           "program_all_reduces": program_all_reduces(m._module)}
    m.load_state(ckpt)
    out["resumed"] = _rows(m.run(xs[half:]), labels)
    out["rows"] = [np.concatenate(ab) for ab in zip(first, out["resumed"])]
    out["wrong_world"] = _wrong_world(bundle, world, rank)
    if rank == (0 if name == "pi" else world - 1):
        out["plain_arrays"] = plain_bundle_arrays(name, kw, sim_kw, world,
                                                  bundle + "_plain")
    return out


def _rows(served, labels):
    return [served[lab] for lab in labels]


def _wrong_world(bundle, world, rank):
    """The error ``ServingModel`` raises on this process group for a copy
    of the bundle's meta.json that records a mesh of ``world + 1``."""
    wrong = f"{bundle}_wrong{rank}"
    os.makedirs(wrong, exist_ok=True)
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    meta["mesh"]["shape"] = [world + 1]
    with open(os.path.join(wrong, "meta.json"), "w") as f:
        json.dump(meta, f)
    try:
        ServingModel(wrong, device="cpu")
    except RuntimeError as e:
        return str(e)
    return None


def program_all_reduces(module) -> int:
    """The all-reduce nodes of a loaded program's graph."""
    return sum(1 for n in module.graph.nodes if n.op == "call_function"
               and "all_reduce" in str(n.target)
               and "wait" not in str(n.target))


def plain_bundle_arrays(name, kw, sim_kw, world, path):
    """The arrays of an unsharded bundle of network ``name``, built as a
    ``world``-way mesh builds it (batched groups padded to ``world``)."""
    from sspslam_tpu_torch.nef import simulator
    build = simulator.build
    simulator.build = lambda *a, **k: build(*a, **{**k,
                                                   "pad_batched_to": world})
    try:
        sim, _ = build_sim(name, kw, **sim_kw)
    finally:
        simulator.build = build
    save_bundle(sim, path, segment_steps=BUNDLE_SEGMENT)
    with np.load(os.path.join(path, "arrays.npz")) as f:
        return {k: f[k] for k in f.files}


def run_dp_tp_bundle(rank, world, device, name, n_steps, shape, bundle):
    """A ("data", "model") mesh of ``shape``: the bundle of the sharded
    Simulator saved from its fresh state (the programs traced at data
    coordinate 0 name that row's model group), the live run, then the
    bundle served on every rank over a mesh built anew; returns the live
    and served rows and the group names (this rank's model group when
    saved, the one the programs record, the one it serves over)."""
    mesh = make_mesh(world, ("data", "model"), shape)
    sim, probes = build_sim(name, {}, mesh=mesh, device=device)
    xs = sim._pack_cols(sim._tabulate_inputs(n_steps))
    save_bundle(sim, bundle, segment_steps=BUNDLE_SEGMENT)
    sim.run_steps(n_steps)
    m = ServingModel(bundle, device=device)
    return {"live": [sim.data[p] for p in probes],
            "served": _rows(m.run(xs), probe_labels(sim, probes, m.meta)),
            "groups": (mesh.group("model").group_name,
                       m.meta["mesh"]["group_name"],
                       m.mesh.group("model").group_name),
            "coords": (mesh.coord("data"), mesh.coord("model")),
            "programs": m.meta["mesh"]["programs"]}


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def run_tie(rank, world, device, bank, queries):
    """The sharded clean-up pick: this rank's rows of ``bank`` (float32,
    its bf16 copy for the similarities) through ``vsa.nearest_row`` under
    a row shard, for each query; returns the picked rows."""
    from sspslam_tpu_torch.nef.executor import StepShard
    from sspslam_tpu_torch.ops import vsa
    import torch.distributed as dist
    b = torch.as_tensor(bank)
    m = b.shape[0] // world
    mine = b[rank * m:(rank + 1) * m].contiguous()
    shard = StepShard(rank, world, dist.group.WORLD)
    vsa.set_row_shard((rank * m, shard))
    try:
        out = vsa.nearest_row(mine, mine.to(torch.bfloat16),
                              torch.as_tensor(queries))
    finally:
        vsa.set_row_shard(None)
    return out.numpy(), len(shard.log)


def run_episodes(rank, world, device, name, kw, n_steps, shape):
    """dp x tp: B episodes (the same tables, scaled per episode) over a
    ("data", "model") mesh of ``shape``; returns the gathered traces."""
    from sspslam_tpu_torch.parallel import run_batched_episodes
    mesh = make_mesh(world, ("data", "model"), shape)
    sim, probes = build_sim(name, kw, mesh=mesh, device=device)
    tables = episode_tables(sim, n_steps, shape[0] * 1)
    res, _ = run_batched_episodes(sim, tables, n_steps, mesh=mesh)
    return [res[p] for p in probes]


def episode_tables(sim, n_steps, B):
    """B copies of the Simulator's input tables, episode b's scaled by
    1 - 0.2 b (so the episodes differ)."""
    cols = sim._tabulate_inputs(n_steps)
    return [np.stack([(1 - 0.2 * b) * np.asarray(c, np.float32)
                      for b in range(B)]) for c in cols]


def run_vco(rank, world, device, arrays, consts, vels, corr):
    """The sharded VCO scan over a world-way model axis: two chunks;
    returns the traces and this rank's kernel-call count a chunk."""
    from sspslam_tpu_torch.ops import vco_scan as vs
    from sspslam_tpu_torch.parallel import make_sharded_vco_scan
    mesh = make_mesh(world)
    params = vs.vco_params_from_numpy(arrays, consts, device=device)
    T = len(vels) // 2
    run = make_sharded_vco_scan(params, None, T, mesh=mesh)
    state = run.initial_state()
    state, a = run(state, vels[:T], corr[:T])
    state, b = run(state, vels[T:], corr[T:])
    return np.concatenate([a.numpy(), b.numpy()]), len(run.shards)


def run_fit(rank, world, device, n, B, steps):
    """test_train.py's data-parallel fit at ``world`` data ranks: B
    episodes of the LIFRate ensemble, the probe decoders trained toward
    -1.5 x the scaled input; returns the losses and the trained leaf."""
    from sspslam_tpu_torch import train
    mesh = make_mesh(world, ("data",))
    sim, pi, xs_b, loss_fn, path = fit_problem(n, B, device)
    bep = train.make_batched_episode_fn(sim, n, segment_steps=50)
    params, losses = train.fit(
        bep, sim.params, xs_b, train.batched_initial_state(sim, B), loss_fn,
        trainable=lambda s: s == path,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-3), steps=steps,
        mesh=mesh)
    return losses, params["probe"][str(pi)]["D"].numpy()


def sine_table(n_steps, dt=0.001, freq=2.0):
    ts = dt * np.arange(1, n_steps + 1)
    return np.sin(2 * np.pi * freq * ts).astype(np.float32)[:, None]


def fit_net(nef, n_steps, n_neurons=30, seed=3):
    """test_train.py's _build: a sine table into one LIFRate ensemble,
    probed through 20 ms (``nef`` is either package's engine)."""
    with nef.Network(seed=seed) as net:
        inp = nef.Node(nef.TimeTable(sine_table(n_steps)))
        ens = nef.Ensemble(n_neurons, 1, neuron_type=nef.LIFRate())
        nef.Connection(inp, ens, synapse=None)
        p = nef.Probe(ens, synapse=0.02)
    return net, p


def fit_targets(n, B):
    """The per-episode input scales, targets and loss mask of
    test_train.py's data-parallel fit."""
    scales = np.random.default_rng(0).uniform(0.3, 1.0, size=B).astype(
        np.float32)
    targ = np.stack([-1.5 * s * sine_table(n) for s in scales])
    mask = (np.arange(n) >= 50).astype(np.float32)[None, :, None]
    return scales, targ, mask


def fit_problem(n, B, device="cpu"):
    from sspslam_tpu_torch import nef, train
    net, p = fit_net(nef, n)
    sim = nef.Simulator(net, seed=3, device=device)
    pi = train.probe_index(sim, p)
    xs1 = train.episode_inputs(sim, n)
    scales, targ, mask = fit_targets(n, B)
    xs_b = np.stack([s * xs1 for s in scales])
    tt = torch.as_tensor(targ, device=device)
    tm = torch.as_tensor(mask, device=device)

    def loss_fn(emits, final_state):
        return torch.sum(tm * (emits[pi] - tt) ** 2) / torch.sum(tm)

    return sim, pi, xs_b, loss_fn, f"probe/{pi}/D"


def run_jobs(rank, world, device, jobs):
    """Several jobs in one spawn: [(function name, args)] of this module,
    each called as fn(rank, world, device, *args); their results."""
    g = globals()
    return [g[name](rank, world, device, *args) for name, args in jobs]


def run_full_width(rank, world, device, steps):
    """bench.py's seed-0 SLAM world at full width, sharded over a
    ``world``-way model axis: the first ``steps`` probe rows, and the
    collectives of a step."""
    from sspslam_tpu_torch import bench
    from sspslam_tpu_torch.experiments.common import (slam_simulator,
                                                      slam_world)
    mesh = make_mesh(world)
    args = bench.parse_args(["--device", device.type])
    sim, probe, _ = slam_simulator(
        bench.make_space(args),
        slam_world(args.world_T, args.n_landmarks, args.seed),
        pi_n_neurons=args.pi_n_neurons, mem_n_neurons=args.mem_n_neurons,
        circonv_n_neurons=args.circonv_n_neurons,
        cleanup_samples=args.cleanup_samples, seed=args.seed,
        device=device, mesh=mesh)
    sim.run_steps(steps)
    return sim.data[probe], sim.mesh_stats()
