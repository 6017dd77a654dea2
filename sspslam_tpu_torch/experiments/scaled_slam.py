"""Scaled-regime SLAM on the port: a 3-D domain, ssp_dim >= 201, 10k-neuron
memory ensembles and B episodes of one built model stepped together.

Port of the JAX package's ``experiments/scaled_slam.py``: the same flags,
worlds (and on-disk table cache), models, decode and printed lines.  The
B per-seed worlds (each its own path and learned map; landmark SPs and
every network parameter shared) run through
:class:`sspslam_tpu_torch.parallel.BatchedEpisodes`: the step under
``torch.func.vmap``, captured as CUDA graphs of ``--graph-steps`` steps,
with the time-major input tables uploaded to the device once.

    python -m sspslam_tpu_torch.experiments.scaled_slam --T 120 --seeds 0,1,2,3
    python -m sspslam_tpu_torch.experiments.scaled_slam --dp-sweep 1,2,8 --T 20

``--device`` (default ``cuda``) names where the simulation runs.  ``mfu``
is taken against the H100's float32 data-sheet peak (``PEAK_F32_FLOPS``,
named in the JSON), and is null off the card.  Not carried: ``--roofline``
and its ``--peak-flops`` / ``--peak-bw`` / ``--measured-us`` (XLA cost
analysis), and ``--scan-unroll`` (``--graph-steps`` takes its place).
Prints one JSON line; add ``--save`` for the npz.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models import (PathIntegration, SLAMNetwork,
                      get_anchor_input_functions, get_slam_input_functions2)
from ..nef import (Connection, Network, Node, Probe, Simulator, TimeTable,
                   WhiteSignal, clamp_table)
from ..nef.simulator import _host
from ..parallel import BatchedEpisodes
from ..sspspace import HexagonalSSPSpace, SPSpace
from ..utils.profiling import model_utilization_summary
from ..utils.sampling import Rd_sampling
from .common import DT, decode_output, kernel_value

#: NVIDIA H100 SXM data sheet: float32 outside the tensor cores, 700 W
PEAK_F32_FLOPS = 67e12
PEAK_NAME = "H100 SXM float32 (non-tensor-core) data-sheet peak, 700 W"


def make_world(args, space, lm_space, seed, shared_scale, space_seed=0):
    """One seed's world: a band-limited path in ``--domain-dim`` dimensions
    and Rd landmarks, rendered to the five input tables (vel, init clamp,
    lm-sp, lm-vecssp, in-view).

    The scale-independent tables are cached on disk (``--table-cache``)
    keyed by the world parameters and the space's seed, in the JAX CLI's
    layout; the velocity scale, which depends on the whole seed set, is
    applied at load."""
    dt = DT
    n_steps = int(args.T / dt)
    dim = args.domain_dim
    cache = None
    if args.table_cache:
        os.makedirs(args.table_cache, exist_ok=True)
        cache = os.path.join(
            args.table_cache,
            f"w{seed}_T{args.T:g}_dim{dim}_d{space.ssp_dim}"
            f"_ls{args.length_scale:g}_lim{args.limit:g}"
            f"_L{args.n_landmarks}_vr{args.view_rad:g}"
            f"_sp{space_seed}.npz")
    if cache and os.path.exists(cache):
        with np.load(cache) as f:
            path, vels = f["path"], f["vels"]
            tables = {k: f[k] for k in
                      ("init", "lm_sp", "lm_vecssp", "in_view")}
        tables["vel"] = (vels * shared_scale).astype(np.float32)
        return path, vels, tables
    path = _path(args, seed)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    obj_locs = 0.9 * 2 * (Rd_sampling(args.n_landmarks, dim, seed=seed) - 0.5)
    vec_to_lm = obj_locs[None, :, :] - path[:, None, :]

    (_, _, in_view_f, _, sp_f, _, vecssp_f) = get_slam_input_functions2(
        space, lm_space, vels, vec_to_lm, args.view_rad)
    tables = {
        "vel": (vels * shared_scale).astype(np.float32),
        "init": clamp_table(space.encode(path[:1]).flatten(), 0.05,
                            dt).rows(0, n_steps),
        "lm_sp": sp_f.rows(0, n_steps),
        "lm_vecssp": vecssp_f.rows(0, n_steps),
        "in_view": in_view_f.rows(0, n_steps),
    }
    if cache:
        np.savez(cache, path=path, vels=vels,
                 **{k: tables[k] for k in
                    ("init", "lm_sp", "lm_vecssp", "in_view")})
    return path, vels, tables


def _path(args, seed):
    """The seed's band-limited path, each axis rescaled into [-0.9, 0.9]."""
    dt = DT
    n_steps = int(args.T / dt)
    path = np.hstack([
        WhiteSignal(args.T, high=args.limit, seed=seed + 77 * i).run(
            args.T, dt=dt)
        for i in range(args.domain_dim)])[:n_steps]
    for i in range(args.domain_dim):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12) * 1.8 - 0.9)
    return path


def _anchor_tables(args, space, seeds, paths, tables_by_seed, n_steps):
    """Survey the top ``--anchor-k`` most-often-nearest-in-view landmarks
    over the first half of every episode (landmark layouts are shared:
    Rd sampling's seed is a sequence offset) and render each episode's
    beacon tables into ``tables_by_seed`` (cached like the world tables).
    Returns (surveyed landmarks, the gate's trigger K(view_rad))."""
    dim = args.domain_dim
    obj_locs = 0.9 * 2 * (
        Rd_sampling(args.n_landmarks, dim, seed=seeds[0]) - 0.5)
    counts = np.zeros(args.n_landmarks, np.int64)
    for path in paths:
        half = path[:n_steps // 2]
        dists = np.linalg.norm(obj_locs[None, :, :] - half[:, None, :],
                               axis=2)
        nearest = dists.argmin(axis=1)
        iv = dists[np.arange(len(half)), nearest] <= args.view_rad
        counts += np.bincount(nearest[iv], minlength=args.n_landmarks)
    anchor_lms = np.sort(np.argsort(counts)[::-1][:args.anchor_k])
    for s, path, tables in zip(seeds, paths, tables_by_seed):
        acache = None
        if args.table_cache:
            aid = "-".join(str(i) for i in anchor_lms.tolist())
            acache = os.path.join(
                args.table_cache,
                f"anc{s}_T{args.T:g}_dim{dim}_d{space.ssp_dim}"
                f"_ls{args.length_scale:g}_lim{args.limit:g}"
                f"_L{args.n_landmarks}_vr{args.view_rad:g}"
                f"_sp{seeds[0]}_k{aid}.npz")
        if acache and os.path.exists(acache):
            with np.load(acache) as f:
                for k in ("anc_pos", "anc_vec", "anc_iv"):
                    tables[k] = f[k]
            continue
        vec_to_lm = obj_locs[None, :, :] - path[:, None, :]
        pos_f, vec_f, iv_f = get_anchor_input_functions(
            space, vec_to_lm, anchor_lms, obj_locs[anchor_lms],
            args.view_rad)
        tables["anc_pos"] = pos_f.rows(0, n_steps)
        tables["anc_vec"] = vec_f.rows(0, n_steps)
        tables["anc_iv"] = iv_f.rows(0, n_steps)
        if acache:
            np.savez(acache, **{k: tables[k] for k in
                                ("anc_pos", "anc_vec", "anc_iv")})
    return anchor_lms, round(kernel_value(space, args.view_rad), 3)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device the simulation and the decode run on")
    ap.add_argument("--T", type=float, default=120.0)
    ap.add_argument("--seeds", default="0,1,2,3",
                    help="one batched episode (world) per seed")
    ap.add_argument("--domain-dim", type=int, default=3)
    ap.add_argument("--ssp-dim", type=int, default=201)
    ap.add_argument("--length-scale", type=float, default=0.3)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=10000)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--n-landmarks", type=int, default=100)
    ap.add_argument("--view-rad", type=float, default=0.4)
    ap.add_argument("--limit", type=float, default=0.1)
    # the JAX package's tuned loop-closure config
    # (experiments/tune_loop_closure.py, round 3)
    ap.add_argument("--update-thres", type=float, default=0.4)
    ap.add_argument("--shift-rate", type=float, default=0.1)
    ap.add_argument("--pes-lr", type=float, default=2e-2)
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--intercept", type=float, default=0.3)
    ap.add_argument("--cleanup-samples", type=int, default=20,
                    help="clean-up bank samples per domain axis (20^3 rows "
                         "in 3-D)")
    ap.add_argument("--decode-grid", type=int, default=30)
    ap.add_argument("--gate-mode", default="reference",
                    choices=["reference", "auto_recovery"],
                    help="auto_recovery steps the in-model tracking-loss "
                         "controller")
    ap.add_argument("--anchor-k", type=int, default=0,
                    help="survey this many landmarks (known allocentric "
                         "pose) and enable the gate's absolute channels "
                         "(requires --gate-mode auto_recovery)")
    ap.add_argument("--decode-method", default="from-set",
                    choices=["from-set", "direct-optim"],
                    help="offline readout: direct-optim adds the batched "
                         "Newton polish to the grid argmax")
    ap.add_argument("--segment-steps", type=int, default=5000)
    ap.add_argument("--probe-every", type=float, default=0.05)
    ap.add_argument("--graph-steps", type=int,
                    default=Simulator.GRAPH_STEPS,
                    help="batched steps per captured CUDA graph")
    ap.add_argument("--bf16", action="store_true",
                    help="alias for --param-dtype bf16")
    ap.add_argument("--param-dtype", default=None,
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="static matmul-parameter storage: bf16, or 1 byte "
                         "a weight with per-slice scales (int8 / fp8, "
                         "ops/quantize.py)")
    ap.add_argument("--no-pi-control", action="store_true",
                    help="skip the PI-only control model (the "
                         "SLAM-vs-drift separation is then not measured)")
    ap.add_argument("--dp-sweep", default=None,
                    help="comma list of B: throughput-only episode-batch "
                         "sweep (world 0 replicated, no probe writes)")
    ap.add_argument("--probe-gate", action="store_true",
                    help="with --gate-mode auto_recovery: probe the "
                         "controller's output and report per-seed recovery "
                         "enters / duty in the JSON")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--save-dir", default="data")
    ap.add_argument("--table-cache", default="data/table_cache",
                    help="directory of the scale-independent input-table "
                         "cache ('' disables)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaled_slam: --device cuda but no CUDA device "
                           "is available (--device cpu runs on the CPU)")
    dt = DT
    n_steps = int(args.T / dt)
    seeds = [int(s) for s in args.seeds.split(",")]
    B = len(seeds)
    dim = args.domain_dim

    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    space = HexagonalSSPSpace(dim, ssp_dim=args.ssp_dim, seed=seeds[0],
                              length_scale=args.length_scale,
                              domain_bounds=bounds)
    d = space.ssp_dim
    lm_space = SPSpace(args.n_landmarks, d, seed=seeds[0])
    print(f"space: {dim}-D, ssp_dim={d} ({(d + 1) // 2} VCOs)", flush=True)

    # one velocity scale for every world: it is baked into the VCO
    # transforms of the one built model
    t0 = time.time()
    max_freq = 0.0
    for s in seeds:
        path = _path(args, s)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        max_freq = max(max_freq, float(np.max(
            np.abs(space.phase_matrix @ vels.T))))
    if max_freq == 0.0:
        raise SystemExit(
            f"degenerate trajectories: WhiteSignal(T={args.T}, "
            f"high={args.limit}) has no spectral content below its "
            f"frequency resolution 1/T={1 / args.T:.3g} Hz — raise --T "
            f"or --limit so that T*limit >= 1")
    shared_scale = 1.0 / max_freq

    paths, tables_by_seed = [], []
    for s in seeds:
        path, vels, tables = make_world(args, space, lm_space, s,
                                        shared_scale, space_seed=seeds[0])
        paths.append(path)
        tables_by_seed.append(tables)
    print(f"worlds: {B} built in {time.time() - t0:.1f}s", flush=True)

    use_anchor = args.anchor_k > 0
    if use_anchor:
        if args.gate_mode != "auto_recovery":
            raise SystemExit("--anchor-k requires --gate-mode "
                             "auto_recovery")
        anchor_lms, anchor_trigger = _anchor_tables(
            args, space, seeds, paths, tables_by_seed, n_steps)
        duty = [float((t["anc_iv"][:, 0] < 1e-3).mean())
                for t in tables_by_seed]
        print(f"anchors: {anchor_lms.tolist()} "
              f"(trigger K(vr)={anchor_trigger}; beacon-in-view duty "
              f"{[round(x, 3) for x in duty]})", flush=True)

    node_key = {}
    with Network(seed=seeds[0]) as net:
        # the input nodes carry world 0; each episode's tables replace them
        inputs = {}
        keys = ["vel", "init", "lm_sp", "lm_vecssp", "in_view"]
        if use_anchor:
            keys += ["anc_pos", "anc_vec", "anc_iv"]
        for k in keys:
            inputs[k] = Node(TimeTable(tables_by_seed[0][k], dt))
            node_key[inputs[k]] = k
        slam = SLAMNetwork(
            space, lm_space, args.view_rad, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons, args.circonv_n_neurons,
            update_thres=args.update_thres, shift_rate=args.shift_rate,
            voja_learning_rate=args.voja_lr, pes_learning_rate=args.pes_lr,
            intercept=args.intercept, vel_scaling_factor=shared_scale,
            cleanup_samples_per_dim=args.cleanup_samples, seed=seeds[0],
            gate_mode=args.gate_mode, anchor=use_anchor,
            gate_kwargs=({"anchor_trigger": anchor_trigger}
                         if use_anchor else None))
        Connection(inputs["vel"], slam.velocity_input, synapse=None)
        Connection(inputs["init"], slam.pathintegrator.input, synapse=None)
        Connection(inputs["lm_sp"], slam.landmark_id_input, synapse=None)
        Connection(inputs["lm_vecssp"], slam.landmark_vec_ssp, synapse=None)
        Connection(inputs["in_view"], slam.no_landmark_in_view,
                   synapse=None)
        if use_anchor:
            Connection(inputs["anc_pos"], slam.anchor_pos_input,
                       synapse=None)
            Connection(inputs["anc_vec"], slam.anchor_vec_ssp, synapse=None)
            Connection(inputs["anc_iv"], slam.no_anchor_in_view,
                       synapse=None)
        slam_p = Probe(slam.pathintegrator.output, synapse=0.05)
        gate_p = None
        if args.probe_gate:
            if args.gate_mode != "auto_recovery":
                raise SystemExit("--probe-gate requires --gate-mode "
                                 "auto_recovery")
            # output layout [correction(d), suppress(1)]; suppress > 5
            # marks the controller's recovery window
            gate_p = Probe(slam.update_state, synapse=None)
        pi_p = None
        if not args.no_pi_control:
            pi_only = PathIntegration(space, args.pi_n_neurons, 0.05,
                                      scaling_factor=shared_scale,
                                      stable=True)
            Connection(inputs["vel"], pi_only.velocity_input, synapse=None)
            Connection(inputs["init"], pi_only.input, synapse=None)
            pi_p = Probe(pi_only.output, synapse=0.05)

    t0 = time.time()
    pd = args.param_dtype or ("bf16" if args.bf16 else "f32")
    mm = None if pd == "f32" else pd
    sim = Simulator(net, seed=seeds[0], matmul_dtype=mm, device=device)
    build_s = time.time() - t0
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)
    flops_step = float(sum(r["flops_per_step"]
                           for r in model_utilization_summary(sim.model)))
    print(f"build: {build_s:.1f}s; {n_neurons:,} LIF neurons, "
          f"{flops_step / 1e6:.1f} MFLOP/step/episode", flush=True)

    seg = min(args.segment_steps, n_steps)
    input_keys = [node_key[n] for n in sim.model.input_nodes]
    per = max(1, int(round(args.probe_every / dt)))
    index = {bp.obj: bp.index for bp in sim.model.probes}

    def mfu(agg):
        if device.type != "cuda":
            return None
        return round(flops_step * agg / PEAK_F32_FLOPS, 6)

    def run_episodes(tabs, total_steps, collect=True):
        """B = len(tabs) episodes in segments of ``seg`` steps (a tail
        shorter than a segment is not run); the first segment captures
        the graphs and is not timed.  Returns (probes, aggregate steps/s,
        first-segment seconds, steps run)."""
        B_eff = len(tabs)
        t0 = time.time()
        tables = [torch.as_tensor(np.stack(
            [np.asarray(t[k][:total_steps], np.float32) for t in tabs],
            axis=1)).to(device) for k in input_keys]
        runner = BatchedEpisodes(sim, tables, graph_steps=args.graph_steps,
                                 collect=collect)
        runner.sync()
        upload_s = time.time() - t0
        kept = ({p: [] for p in (slam_p, pi_p, gate_p) if p is not None}
                if collect else None)
        # --probe-gate also snapshots the controller's state slot at each
        # segment boundary ([armed, agree_ema, timer, cons_ema(, anchor)])
        gate_states = [] if (collect and gate_p is not None) else None
        t_compile = t_run = 0.0
        done = 0
        while done < total_steps:
            hi = min(done + seg, total_steps)
            if hi - done < seg:
                break
            t0 = time.time()
            bufs = runner.run(seg)
            runner.sync()
            el = time.time() - t0
            if done == 0:
                t_compile = el
                print(f"  tables uploaded once ({upload_s:.2f}s); "
                      f"capture+warm {el:.1f}s", flush=True)
            else:
                t_run += el
            if collect:
                phase = (per - 1 - done % per) % per
                for p in kept:
                    kept[p].append(_host(bufs[index[p]][phase::per]))
                if gate_states is not None:
                    gate_states.append({k: _host(v) for k, v
                                        in runner.state["nodes"].items()})
            done = hi
        steps_timed = done - seg
        if t_run > 0:
            agg = B_eff * steps_timed / t_run
        else:   # a single segment: capture and run is all there is
            agg = B_eff * done / max(t_compile, 1e-9)
        probes = None
        if collect:
            probes = {p: np.swapaxes(np.concatenate(v), 0, 1)
                      for p, v in kept.items()}
            if gate_states is not None:
                probes["gate_states"] = {
                    k: np.stack([gs[k] for gs in gate_states])
                    for k in gate_states[0]} if gate_states else {}
        del runner
        return probes, agg, t_compile, done

    if args.dp_sweep:
        rows = []
        for Bx in [int(x) for x in args.dp_sweep.split(",")]:
            _, agg, t_c, done = run_episodes([tables_by_seed[0]] * Bx,
                                             n_steps, collect=False)
            r = {"B": Bx, "agg_steps_per_s": round(agg, 1), "mfu": mfu(agg),
                 "compile_s": round(t_c, 1)}
            rows.append(r)
            print(json.dumps(r), flush=True)
        print(json.dumps({
            "metric": f"scaled {dim}-D SLAM DP sweep (ssp_dim={d}, "
                      f"mem={args.mem_n_neurons}, dtype={pd})",
            "value": rows[-1]["agg_steps_per_s"], "unit": "steps/s",
            "vs_baseline": None, "dp_sweep": rows,
            "device": _device_name(device), "mfu_peak_flops": PEAK_F32_FLOPS,
            "mfu_peak": PEAK_NAME}))
        return

    t0 = time.time()
    probes, agg, t_compile, done = run_episodes(tables_by_seed, n_steps)
    wall = time.time() - t0
    print(f"sim: {B} episodes x {done} steps, capture+first "
          f"{t_compile:.1f}s, steady {agg:.0f} agg steps/s, total "
          f"{wall:.1f}s", flush=True)

    # decoded tracking error per seed (the second half: the map is built)
    results = []
    k = probes[slam_p].shape[1]
    for b, s in enumerate(seeds):
        path_s = paths[b][per - 1::per][:k]
        entry = {"seed": s}
        for name, p in (("slam", slam_p), ("pi_only", pi_p)):
            if p is None:
                continue
            est = decode_output(space, probes[p][b], dim,
                                grid=args.decode_grid,
                                method=args.decode_method, device=device)
            err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
            half = err[len(err) // 2:]
            entry[name] = {"median_err": round(float(np.median(half)), 4),
                           "final_err": round(float(err[-1]), 4)}
        if gate_p is not None:
            sup = probes[gate_p][b][:, -1] > 5.0
            rises = int(np.sum(sup[1:] & ~sup[:-1])) + int(sup[0])
            entry["gate"] = {
                "enters": rises,
                "recovery_frac": round(float(sup.mean()), 4),
                "first_enter_s": (round(float(
                    np.argmax(sup) * args.probe_every), 2)
                    if sup.any() else None)}
            # the controller's state at the LAST segment boundary
            for slot, tr in probes["gate_states"].items():
                if tr.shape[-1] in (4, 5):
                    entry["gate"]["final_state"] = [
                        round(float(v), 4) for v in tr[-1, b]]
        results.append(entry)
        print(json.dumps(entry), flush=True)

    med_slam = float(np.median([r["slam"]["median_err"] for r in results]))
    out = {
        "metric": f"scaled {dim}-D SLAM (ssp_dim={d}, "
                  f"mem={args.mem_n_neurons}, {n_neurons} LIF, "
                  f"B={B} batched episodes, dtype={pd})",
        "value": round(agg, 1), "unit": "steps/s",
        "agg_steps_per_s": round(agg, 1),
        "us_per_episode_step": round(1e6 / agg, 3),
        "mfu": mfu(agg),
        "flops_per_step_per_episode": flops_step,
        "median_err_slam": round(med_slam, 4),
        "per_seed": results,
        "T": args.T, "config": {
            "ssp_dim": d, "domain_dim": dim,
            "length_scale": args.length_scale,
            "param_dtype": pd, "decode_method": args.decode_method,
            "mem_n_neurons": args.mem_n_neurons,
            "pi_n_neurons": args.pi_n_neurons,
            "n_landmarks": args.n_landmarks, "view_rad": args.view_rad,
            "update_thres": args.update_thres,
            "shift_rate": args.shift_rate, "pes_lr": args.pes_lr,
            "voja_lr": args.voja_lr, "intercept": args.intercept,
            "gate_mode": args.gate_mode, "anchor_k": args.anchor_k},
        "device": _device_name(device), "build_s": round(build_s, 1),
        "mfu_peak_flops": PEAK_F32_FLOPS, "mfu_peak": PEAK_NAME,
    }
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    if use_anchor:
        out["anchors"] = {"landmarks": anchor_lms.tolist(),
                          "trigger": anchor_trigger}
    print(json.dumps(out))
    if args.save:
        os.makedirs(args.save_dir, exist_ok=True)
        fn = os.path.join(args.save_dir,
                          f"scaled_slam_d{d}_dim{dim}_"
                          f"mem{args.mem_n_neurons}_B{B}_T{int(args.T)}"
                          f"_{pd}.npz")
        extra = {}
        if gate_p is not None:
            extra["gate_out"] = probes[gate_p]
            for slot, tr in probes["gate_states"].items():
                extra[f"gate_state_{slot}"] = tr
        np.savez(fn, slam_out=probes[slam_p],
                 pi_out=(probes[pi_p] if pi_p else np.array([])),
                 paths=np.stack(paths), meta=np.array([json.dumps(out)]),
                 **extra)
        print(f"saved {fn}")


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    main()
