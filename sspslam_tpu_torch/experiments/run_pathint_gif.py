"""Path-integration run + animated GIF on the port: a similarity heatmap
over the domain, VCO phase portraits and spike rasters; the flags, printed
lines and output file of the JAX package's
``experiments/run_pathint_gif.py``, with ``--device`` (default ``cuda``)
naming where the simulation runs (``--backend cpu`` is ``--device cpu``).

    python -m sspslam_tpu_torch.experiments.run_pathint_gif [--device cpu]

:func:`simulate` builds and runs the network and reads out every frame's
arrays (it needs no matplotlib); :func:`render` draws the GIF from them
(matplotlib and PIL).
"""

import argparse
import os
import time

import numpy as np

from ..models import PathIntegration
from ..nef import LIF, Connection, Network, Node, Probe, Simulator
from ..utils.spikes import cluster, sample_by_variance
from .common import DT, add_common_args, make_path, make_space

BACKENDS = {"jit": "jit", "ocl": "jit", "tpu": "jit", "cpu": "cpu",
            "numpy": "numpy", "gated": "gated", "loihi": "gated",
            "loihi-sim": "gated"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=10.0)
    parser.add_argument("--backend", default="jit", type=str,
                        help="jit|cpu (cpu: --device cpu; the other names "
                             "of the JAX CLIs run the Simulator too)")
    parser.add_argument("--pi-n-neurons", default=500, type=int)
    parser.add_argument("--n-frames", default=60, type=int)
    parser.add_argument("--n-grid", default=50, type=int,
                        help="similarity heatmap resolution")
    parser.add_argument("--out", default="figures/pathint.gif")
    args = parser.parse_args(argv)
    if args.backend.lower() not in BACKENDS:
        raise SystemExit(f"unknown backend {args.backend!r}")
    if BACKENDS[args.backend.lower()] == "cpu":
        args.device = "cpu"
    return args


def build(args):
    """The world, the network and its Simulator on ``args.device``."""
    dt = DT
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=49999)
    if domain_dim != 2:
        raise SystemExit("the GIF renders a 2-D domain")
    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    real_ssp0 = ssp_space.encode(path[:1])[0]
    scale_fac = 1 / np.max(np.abs(ssp_space.phase_matrix @ vels.T))
    vels_scaled = vels * scale_fac
    pathlen = path.shape[0]

    sample_every = T / args.n_frames
    with Network(seed=args.seed) as model:
        vel_input = Node(lambda t: vels_scaled[min(int((t - dt) / dt),
                                                   pathlen - 1)])
        init_state = Node(lambda t: real_ssp0 if t < 0.05 else np.zeros(d))
        pi = PathIntegration(ssp_space, args.pi_n_neurons, 0.05,
                             scaling_factor=scale_fac, stable=True,
                             neuron_type=LIF())
        Connection(vel_input, pi.velocity_input, synapse=None)
        Connection(init_state, pi.input, synapse=None)
        out_p = Probe(pi.output, synapse=0.05, sample_every=sample_every)
        osc_p = Probe(pi.oscillators.output, synapse=0.05,
                      sample_every=sample_every)
        spike_p = Probe(pi.oscillators.neurons, sample_every=dt * 5)

    sim = Simulator(model, seed=args.seed, progress=True, device=args.device)
    return {"sim": sim, "probes": (out_p, osc_p, spike_p), "T": T,
            "path": path, "space": ssp_space, "radius": radius,
            "sample_every": sample_every,
            "n_oscillators": len(pi.oscillators.ea_ensembles)}


def simulate(args, built=None):
    """Run ``built`` (default: :func:`build` of ``args``) for T seconds and
    read out the frames: the probed SSP, oscillator and raster traces, the
    similarity heatmap of every frame and the clustered raster of the 200
    most variable neurons.  Returns a dict of arrays (and the run's wall
    seconds and steps/s)."""
    built = built or build(args)
    sim, (out_p, osc_p, spike_p) = built["sim"], built["probes"]
    T, dt, radius = built["T"], DT, built["radius"]
    n_steps = int(round(T / dt))
    sim.preload_inputs(n_steps)
    sim.compile(n_steps)
    t0 = time.perf_counter()
    sim.run(T)
    sim.sync()
    seconds = time.perf_counter() - t0

    out = sim.data[out_p]
    osc = sim.data[osc_p]
    spikes = sim.data[spike_p].reshape(sim.data[spike_p].shape[0], -1)

    # similarity heatmap grid
    xs = np.linspace(-radius, radius, args.n_grid)
    X, Y = np.meshgrid(xs, xs)
    grid_ssps = built["space"].encode(np.stack([X.reshape(-1),
                                                Y.reshape(-1)], axis=1))
    sims = (out @ grid_ssps.T).reshape(-1, args.n_grid, args.n_grid)

    # raster preprocessing: most variable 200 neurons, clustered
    sp_t = dt * 5 * np.arange(1, spikes.shape[0] + 1)
    _, sp = sample_by_variance(sp_t, spikes, 200, filter_width=0.02)
    _, sp = cluster(sp_t, sp, filter_width=0.02)
    return {"out": out, "osc": osc, "spikes": spikes, "raster": sp,
            "sims": sims, "path": built["path"], "radius": radius,
            "sample_every": built["sample_every"],
            "n_oscillators": built["n_oscillators"],
            "seconds": seconds, "steps_per_s": n_steps / seconds}


def render(res, out_path):
    """The GIF of :func:`simulate`'s frames (matplotlib, PIL)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    dt, radius, path = DT, res["radius"], res["path"]
    out, osc, sp, sims = res["out"], res["osc"], res["raster"], res["sims"]
    pathlen = path.shape[0]
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.2))
    im = axes[0].imshow(sims[0], origin="lower",
                        extent=[-radius, radius, -radius, radius],
                        cmap="viridis", vmin=-0.2, vmax=1.0)
    (true_pt,) = axes[0].plot([], [], "r+", ms=10)
    axes[0].set_title("similarity map")

    n_show = min(3, res["n_oscillators"] - 1)
    phase_lines = []
    for j in range(n_show):
        (ln,) = axes[1].plot([], [], lw=1)
        phase_lines.append(ln)
    axes[1].set_xlim(-1.2, 1.2); axes[1].set_ylim(-1.2, 1.2)
    axes[1].set_title("VCO phase portraits")
    axes[1].set_aspect("equal")

    raster = axes[2]
    raster.set_title("spikes")
    raster_img = raster.imshow(np.zeros((sp.shape[1], 10)), aspect="auto",
                               origin="lower", cmap="Greys",
                               extent=[0, 1, 0, sp.shape[1]])

    steps_per_frame = max(1, int(round(res["sample_every"] / dt)))

    def update(f):
        im.set_data(sims[f])
        k = min((f + 1) * steps_per_frame, pathlen) - 1
        true_pt.set_data([path[k, 0]], [path[k, 1]])
        for j, ln in enumerate(phase_lines):
            ln.set_data(osc[: f + 1, 3 * (j + 1)],
                        osc[: f + 1, 3 * (j + 1) + 1])
        sp_k = int((f + 1) / out.shape[0] * sp.shape[0])
        window = sp[max(0, sp_k - 200): sp_k].T
        if window.size:
            raster_img.set_data(window > 0)
            raster_img.set_extent([0, window.shape[1], 0, window.shape[0]])
        return [im, true_pt, *phase_lines, raster_img]

    anim = FuncAnimation(fig, update, frames=out.shape[0], blit=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=PillowWriter(fps=8))
    plt.close(fig)
    print(f"saved {out_path}")


def main(argv=None):
    args = parse_args(argv)
    res = simulate(args)
    render(res, args.out)
    return res


if __name__ == "__main__":
    main()
