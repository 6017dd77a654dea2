"""SLAM run + animated GIF on the port: the posterior similarity heatmap
and the learned landmark map over time, reconstructed from the PES
decoders and Voja encoders probed every frame; the flags, printed lines
and output file of the JAX package's ``experiments/run_slam_map_gif.py``,
with ``--device`` (default ``cuda``) naming where the simulation runs
(``--backend cpu`` is ``--device cpu``).

    python -m sspslam_tpu_torch.experiments.run_slam_map_gif [--device cpu]

:func:`simulate` builds and runs the network and decodes every frame's map
through the memory's rates (``rates_np``; it needs no matplotlib);
:func:`render` draws the GIF from them (matplotlib and PIL).
"""

import argparse
import os
import time

import numpy as np

from ..models import SLAMNetwork, get_slam_input_functions
from ..nef import Connection, Network, Node, Probe, Simulator
from ..sspspace import SPSpace
from ..utils import Rd_sampling
from .common import DT, add_common_args, make_path, make_space
from .run_pathint_gif import BACKENDS


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=60.0)
    parser.add_argument("--backend", default="jit", type=str,
                        help="jit|cpu (cpu: --device cpu; the other names "
                             "of the JAX CLIs run the Simulator too)")
    parser.add_argument("--n-landmarks", default=6, type=int)
    parser.add_argument("--view-rad", default=0.4, type=float)
    parser.add_argument("--pi-n-neurons", default=500, type=int)
    parser.add_argument("--mem-n-neurons", default=600, type=int)
    parser.add_argument("--circonv-n-neurons", default=70, type=int)
    parser.add_argument("--n-frames", default=40, type=int)
    parser.add_argument("--n-grid", default=40, type=int)
    parser.add_argument("--out", default="figures/slam_map.gif")
    args = parser.parse_args(argv)
    if args.backend.lower() not in BACKENDS:
        raise SystemExit(f"unknown backend {args.backend!r}")
    if BACKENDS[args.backend.lower()] == "cpu":
        args.device = "cpu"
    return args


def build(args):
    """The world, the network and its Simulator on ``args.device``."""
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=99999)
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, domain_dim, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]
    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    real_ssp0 = ssp_space.encode(path[:1])[0]
    lm_space = SPSpace(args.n_landmarks, d, seed=args.seed)

    (velocity_func, vel_scaling_factor, is_landmark_in_view, _,
     landmark_sp_func, _, landmark_vecssp_func) = get_slam_input_functions(
        ssp_space, lm_space, vels, vec_to_landmarks, args.view_rad)

    frame_every = T / args.n_frames
    with Network(seed=args.seed) as model:
        vel_input = Node(velocity_func)
        init_state = Node(lambda t: real_ssp0 if t < 0.05 else np.zeros(d))
        landmark_vec = Node(landmark_vecssp_func)
        landmark_id = Node(landmark_sp_func)
        is_landmark = Node(is_landmark_in_view)
        slam = SLAMNetwork(ssp_space, lm_space, args.view_rad,
                           args.n_landmarks, args.pi_n_neurons,
                           args.mem_n_neurons, args.circonv_n_neurons,
                           vel_scaling_factor=vel_scaling_factor,
                           voja_learning_rate=1e-4, pes_learning_rate=5e-3,
                           intercept=0.1, seed=args.seed)
        Connection(vel_input, slam.velocity_input, synapse=None)
        Connection(init_state, slam.pathintegrator.input, synapse=None)
        Connection(landmark_vec, slam.landmark_vec_ssp, synapse=None)
        Connection(landmark_id, slam.landmark_id_input, synapse=None)
        Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
        out_p = Probe(slam.pathintegrator.output, synapse=0.05,
                      sample_every=frame_every)
        weights_p = Probe(slam.assomemory.conn_out, attr="weights",
                          sample_every=frame_every)
        enc_p = Probe(slam.assomemory.conn_in.learning_rule,
                      attr="scaled_encoders", sample_every=frame_every)

    sim = Simulator(model, seed=args.seed, progress=True, device=args.device)
    be = next(b for b in sim.model.ensembles
              if b.obj is slam.assomemory.memory)
    return {"sim": sim, "probes": (out_p, weights_p, enc_p), "T": T,
            "path": path, "space": ssp_space, "lm_space": lm_space,
            "memory": be, "obj_locs": obj_locs, "radius": radius,
            "frame_every": frame_every}


def simulate(args, built=None):
    """Run ``built`` (default: :func:`build` of ``args``) for T seconds and
    read out every frame: the position posterior's heatmap, and the learned
    landmark map (the memory's rates on the landmark SPs through that
    frame's Voja encoders, times its PES decoders; the max over landmarks
    of each map's normalised similarity).  Returns a dict of arrays (and
    the run's wall seconds and steps/s)."""
    built = built or build(args)
    sim, (out_p, weights_p, enc_p) = built["sim"], built["probes"]
    T, radius, be = built["T"], built["radius"], built["memory"]
    n_steps = int(round(T / DT))
    sim.preload_inputs(n_steps)
    sim.compile(n_steps)
    t0 = time.perf_counter()
    sim.run(T)
    sim.sync()
    seconds = time.perf_counter() - t0
    out = sim.data[out_p]
    weights = sim.data[weights_p]       # (F, d, n)
    encs = sim.data[enc_p]              # (F, n, d)
    n_frames = min(out.shape[0], weights.shape[0], encs.shape[0])

    xs = np.linspace(-radius, radius, args.n_grid)
    X, Y = np.meshgrid(xs, xs)
    grid_ssps = built["space"].encode(np.stack([X.reshape(-1),
                                                Y.reshape(-1)], axis=1))
    grid = (args.n_grid, args.n_grid)
    posterior = (out[:n_frames] @ grid_ssps.T).reshape(n_frames, *grid)
    maps = np.empty((n_frames,) + grid)
    for f in range(n_frames):
        J = built["lm_space"].vectors @ encs[f].T + be.bias
        acts = be.neuron_type.rates_np(J)
        lm_ssps = acts @ weights[f].T            # (L, d)
        lm_maps = grid_ssps @ lm_ssps.T          # (G, L)
        norm = np.maximum(np.linalg.norm(lm_ssps, axis=1), 1e-6)
        maps[f] = (lm_maps / norm).max(axis=1).reshape(grid)
    return {"out": out, "weights": weights, "encoders": encs,
            "posterior": posterior, "maps": maps, "path": built["path"],
            "obj_locs": built["obj_locs"], "radius": radius,
            "frame_every": built["frame_every"], "seconds": seconds,
            "steps_per_s": n_steps / seconds}


def render(res, out_path):
    """The GIF of :func:`simulate`'s frames (matplotlib, PIL)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    radius, path, obj_locs = res["radius"], res["path"], res["obj_locs"]
    posterior, maps = res["posterior"], res["maps"]
    pathlen = path.shape[0]
    blank = np.zeros(posterior.shape[1:])
    fig, axes = plt.subplots(1, 2, figsize=(8, 3.6))
    im0 = axes[0].imshow(blank, origin="lower",
                         extent=[-radius, radius, -radius, radius],
                         cmap="viridis", vmin=-0.2, vmax=1.0)
    (true_pt,) = axes[0].plot([], [], "r+", ms=10)
    axes[0].set_title("position posterior")
    im1 = axes[1].imshow(blank, origin="lower",
                         extent=[-radius, radius, -radius, radius],
                         cmap="magma", vmin=-0.2, vmax=1.0)
    axes[1].scatter(obj_locs[:, 0], obj_locs[:, 1], c="cyan", marker="x")
    axes[1].set_title("learned landmark map (max over landmarks)")

    steps_per_frame = max(1, int(round(res["frame_every"] / DT)))

    def update(f):
        im0.set_data(posterior[f])
        k = min((f + 1) * steps_per_frame, pathlen) - 1
        true_pt.set_data([path[k, 0]], [path[k, 1]])
        im1.set_data(maps[f])
        return [im0, im1, true_pt]

    anim = FuncAnimation(fig, update, frames=len(maps), blit=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=PillowWriter(fps=6))
    plt.close(fig)
    print(f"saved {out_path}")


def main(argv=None):
    args = parse_args(argv)
    res = simulate(args)
    render(res, args.out)
    return res


if __name__ == "__main__":
    main()
