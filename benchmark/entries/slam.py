"""The flagship SLAM network of ``run_slam.py`` through the program's
Simulator: one robot's world, stepped closed loop in units of
``unit_steps`` steps.

Set-up builds what ``run_slam.py`` builds (its landmarks from R_d, the
landmark SPs, the input nodes of ``get_slam_input_functions2``, the
``SLAMNetwork`` and the PI output's probe at 50 ms), on
``Simulator(device=...)``, preloads the whole world's input table on the
device and captures the step's graphs.  A unit of the window is
``run_steps(unit_steps)`` (one segment: replays of the 10-step graph),
ended by its PI output rows on the host.  At the world's end the run
starts the same world again (``reset(keep_inputs=True)``: the graphs are
kept, the learned map starts again).

The check: one unit among the window's first ``check_within``, drawn from
the seed among those that start with a landmark in view, is judged
through a clone of the whole state at its start (after a sync).  After
the window, the program still built, the clone is loaded back and
``check_rows`` steps are replayed through the same graphs: their rows must
equal the window's, and the state they leave is what the reference's
steps from the same clone are held to (:mod:`benchmark.reference.
slam_check`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from benchmark.harness import core, slam_counts
from benchmark.harness import slam_world as SW
from benchmark.harness import world as W


def _network(ctx, path, vels, ms):
    """run_slam.py's world adapters, network and Simulator."""
    from sspslam_tpu_torch.models import (SLAMNetwork,
                                          get_slam_input_functions2)
    from sspslam_tpu_torch.nef import (Connection, Network, Node, Probe,
                                       Simulator)
    from sspslam_tpu_torch.sspspace import HexagonalSSPSpace, SPSpace
    from sspslam_tpu_torch.utils import Rd_sampling
    cfg, dt = ctx.cfg, ctx.cfg["dt"]
    n, d, r = cfg["domain_dim"], cfg["ssp_dim"], cfg["domain_bound"]
    L = cfg["n_landmarks"]
    with ctx.spans.span("warmup"):
        # run_slam.py passes its seed as the R_d sequence's offset
        obj_locs = 0.9 * r * 2 * (Rd_sampling(L, n, seed=ms) - 0.5)
        vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]
    with ctx.spans.span("build"):
        space = HexagonalSSPSpace(
            n, ssp_dim=d, domain_bounds=r * np.tile([-1.0, 1.0], (n, 1)),
            length_scale=cfg["length_scale"], seed=ms)
        lm_space = SPSpace(L, d, seed=ms)
    with ctx.spans.span("warmup"):
        real_init = space.encode(path[:60])
        (velocity_func, vel_scaling_factor, is_landmark_in_view, _,
         landmark_sp_func, _, landmark_vecssp_func) = \
            get_slam_input_functions2(space, lm_space, vels,
                                      vec_to_landmarks, cfg["view_rad"])
    del vec_to_landmarks
    with ctx.spans.span("build"):
        with Network(seed=ms) as model:
            vel_input = Node(velocity_func, label="vel_input")
            init_state = Node(
                lambda t: real_init[min(int((t - dt) / dt), 59)]
                if t < cfg["clamp_s"] else np.zeros(d), label="init_state")
            landmark_vec = Node(landmark_vecssp_func,
                                label="lm_vecssp_input")
            landmark_id = Node(landmark_sp_func, label="lm_sp_input")
            is_landmark = Node(is_landmark_in_view, label="lm_in_view_input")
            slam = SLAMNetwork(
                space, lm_space, cfg["view_rad"], L, cfg["pi_n_neurons"],
                cfg["mem_n_neurons"], cfg["circonv_n_neurons"],
                tau=cfg["tau"], tau_pi=cfg["recurrent_tau"],
                update_thres=cfg["update_thres"],
                vel_scaling_factor=vel_scaling_factor,
                shift_rate=cfg["shift_rate"],
                voja_learning_rate=cfg["voja_lr"],
                pes_learning_rate=cfg["pes_lr"],
                intercept=cfg["intercept"], clean_up_method="grid",
                cleanup_samples_per_dim=cfg["cleanup_samples_per_dim"],
                gc_n_neurons=0, voja=True, seed=ms)
            Connection(landmark_vec, slam.landmark_vec_ssp, synapse=None)
            Connection(landmark_id, slam.landmark_id_input, synapse=None)
            Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
            Connection(vel_input, slam.velocity_input, synapse=None)
            Connection(init_state, slam.pathintegrator.input, synapse=None)
            probe = Probe(slam.pathintegrator.output,
                          synapse=cfg["probe_synapse"])
        sim = Simulator(model, seed=ms, device=ctx.device)
    return sim, slam, probe


def setup(ctx):
    with ctx.spans.span("import"):
        import sspslam_tpu_torch  # noqa: F401
    cfg, mix = ctx.cfg, ctx.mix
    ms = W.model_seed(ctx.seed)
    with ctx.spans.span("traffic"):
        path, vels = SW.path(mix, ctx.seed)
        view = SW.in_view(cfg, path[:mix["check_within"]
                                    * mix["unit_steps"]],
                          SW.landmarks(cfg, ms)).any(axis=1)
    sim, slam, probe = _network(ctx, path, vels, ms)
    U, K = mix["unit_steps"], mix["check_rows"]
    bp = next(p for p in sim.model.probes if p.obj is probe)
    with ctx.spans.span("warmup"):
        sim.preload_inputs(path.shape[0])
        sim.compile(U)
    # the judged unit: drawn from the seed among the first units that
    # start with a landmark in view for the K steps the check replays
    seen = [u for u in range(1, mix["check_within"])
            if view[u * U:u * U + K].all()] or list(
                range(1, mix["check_within"]))
    rng = np.random.default_rng([int(ctx.seed), 1 << 20])
    return {"sim": sim, "slam": slam, "bp": bp, "done": 0,
            "world_steps": path.shape[0], "pick": int(rng.choice(seen)),
            "first": None, "snap": None, "track": [], "times": []}


def trace_units(ctx) -> int:
    return ctx.mix["trace_units"]


def _rows(sim, bp):
    """The last segment's rows of the probe, on the host; the Simulator
    keeps no earlier ones."""
    chunks = sim._probe_data[bp.index]
    rows = chunks[-1].cpu().numpy()
    chunks.clear()
    return rows


def _host(x):
    """A float64 (float leaves) host copy of a state leaf."""
    x = x.detach().cpu()
    return (x.double() if x.is_floating_point() else x).numpy()


def unit(ctx, st):
    sim, mix = st["sim"], ctx.mix
    U, K = mix["unit_steps"], mix["check_rows"]
    if ctx.sliced is not None and "prof" in ctx.sliced \
            and getattr(ctx, "slam_prof", None) is None:
        # the slice's profile, kept for the readers of its device records
        ctx.slam_prof = ctx.sliced["prof"]
    if sim.n_steps + U > st["world_steps"]:
        sim.reset(keep_inputs=True)
    u = st["done"]
    if u == st["pick"]:
        sim.sync()
        st["snap"] = (tree_map(torch.clone, sim.state), sim.n_steps)
    with ctx.spans.span("unit"):
        t0 = time.perf_counter()
        start = sim.n_steps
        sim.run_steps(U)
        rows = _rows(sim, st["bp"])
        st["times"].append(time.perf_counter() - t0)
    if u == 0:
        st["first"] = rows[:K].copy()
    if u == st["pick"]:
        st["chunk_rows"] = rows[:K].copy()
    e = mix["track_every"]
    st["track"].append((start + np.arange(e - 1, U, e), rows[e - 1::e]))
    st["done"] += 1
    return U


def _log_times(times):
    """The window's units slower than the median by more than 5 %: how
    many, and where (the card's slower launch-gap mode shows so)."""
    if not times:
        return
    med = float(np.median(times))
    slow = [i for i, t in enumerate(times) if t > 1.05 * med]
    core.log(f"unit times: median {med:.6f} s; {len(slow)} of "
             f"{len(times)} slower than 1.05 x median, at {slow[:40]}")


def flops_per_step(ctx):
    """The step's model operations (:mod:`benchmark.harness.slam_counts`,
    from the reference's shapes)."""
    return slam_counts.step(ctx.cfg)["flops"]


def program_outputs(ctx, st):
    from benchmark.reference import slam_check
    sim, mix = st["sim"], ctx.mix
    ctx.window["attempted"] = st["done"]
    K = mix["check_rows"]
    _log_times(st["times"])
    # a window shorter than the judged unit (a short run) runs on to it,
    # untimed; its rows are not the window's
    track = list(st["track"])
    while st["snap"] is None and st["done"] <= st["pick"]:
        unit(ctx, st)
    sim.sync()
    lay = slam_check.layout(sim.model, st["slam"], st["bp"])
    out = {"tables": slam_check.program_tables(sim, lay),
           "decoders": slam_check.program_decoders(sim, lay),
           "first": st["first"], "track": track, "unit": st["pick"],
           "world_steps": st["world_steps"]}
    if st["snap"] is not None:
        snap, step = st["snap"]
        for dst, src in zip(tree_leaves(sim.state), tree_leaves(snap)):
            dst.copy_(src)
        sim.n_steps = step
        sim.run_steps(K)
        replay = _rows(sim, st["bp"])
        out.update(snap=slam_check.program_state(tree_map(_host, snap),
                                                 lay),
                   after=slam_check.program_state(
                       tree_map(_host, sim.state), lay),
                   snap_step=step, chunk_rows=st["chunk_rows"],
                   replay_equal=bool(np.array_equal(replay,
                                                    st["chunk_rows"])))
    return out


def reference_check(ctx, out):
    from benchmark.reference import slam_check
    slam_check.judge(ctx, out)


def readings(cfg, mix, seed, device, out):
    """The program's and the control's compared numbers (the control's
    script)."""
    from benchmark.reference import slam_check
    return slam_check.readings(cfg, mix, seed, device, out)
