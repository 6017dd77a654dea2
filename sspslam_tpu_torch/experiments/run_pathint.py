"""Path-integration CLI on the port: the flags, metrics, npz schema and
printed lines of the JAX package's ``experiments/run_pathint.py``, with
``--device`` (default ``cuda``) naming where the simulation runs.

    python -m sspslam_tpu_torch.experiments.run_pathint [--device cpu] \
        [--backend jit|cpu|numpy] ...

``--backend jit`` (default) steps the network with the port's
:class:`Simulator` (CUDA graphs on the card); ``cpu`` is the same on
``--device cpu``; ``numpy`` runs the NumPy interpreter on the host over
the model built on ``--device``.
"""

import argparse
import os
import time

import numpy as np

from ..models import PathIntegration
from ..nef import (LIF, Connection, Ensemble, LIFRate, LoihiLIF, Network,
                   Node, Probe, QuantizedLIF, RectifiedLinear, Simulator,
                   TimeTable)
from .common import (DT, add_common_args, decode_output, make_path,
                     make_space, run_with_backend, save_npz)

BACKENDS = {"jit": "jit", "ocl": "jit", "tpu": "jit", "cpu": "cpu",
            "numpy": "numpy"}


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=20.0)
    parser.add_argument("--pi-n-neurons", default=800, type=int,
                        help="Neurons per VCO population")
    parser.add_argument("--neuron-type", default="lif",
                        help="lif | lifrate | relu | loihi | quantized")
    parser.add_argument("--approx-vel", action="store_true",
                        help="Route velocity through a noisy neural population")
    parser.add_argument("--vel-n-neurons", default=500, type=int)
    parser.add_argument("--backend", default="jit",
                        help="jit: the Simulator on --device; cpu: the "
                             "same on the CPU; numpy: the NumPy "
                             "interpreter on the host")
    args = parser.parse_args(argv)
    if args.backend.lower() not in BACKENDS:
        raise SystemExit(f"unknown backend {args.backend!r}")
    backend = BACKENDS[args.backend.lower()]
    device = "cpu" if backend == "cpu" else args.device

    dt = DT
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=49999)
    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    # encode only rows actually consumed (init clamp + strided error eval)
    real_init = ssp_space.encode(path[:60])

    scale_fac = 1 / np.max(np.abs(ssp_space.phase_matrix @ vels.T))
    vels_scaled = vels * scale_fac
    pathlen = path.shape[0]

    neuron_type = {"lif": LIF(), "lifrate": LIFRate(),
                   "relu": RectifiedLinear(), "loihi": LoihiLIF(),
                   "quantized": QuantizedLIF()}[args.neuron_type]

    tau = 0.05
    with Network(seed=args.seed) as model:
        if args.approx_vel:
            vel_syn = 0.01
            _vel_input = Node(lambda t: vels_scaled[
                min(int((t - dt) / dt), pathlen - 1)], label="vel_input")
            vel_input = Ensemble(args.vel_n_neurons, domain_dim)
            Connection(_vel_input, vel_input, synapse=None)
            vel_p = Probe(vel_input, synapse=vel_syn)
        else:
            vel_syn = None
            vel_input = Node(TimeTable(vels_scaled, dt), label="vel_input")

        init_state = Node(lambda t: real_init[min(int((t - dt) / dt), 59)]
                          if t < 0.05 else np.zeros(d))
        pathintegrator = PathIntegration(ssp_space, args.pi_n_neurons, tau,
                                         scaling_factor=scale_fac,
                                         stable=True)
        Connection(vel_input, pathintegrator.velocity_input, synapse=vel_syn)
        Connection(init_state, pathintegrator.input, synapse=None)
        ssp_p = Probe(pathintegrator.output, synapse=0.05)

    sim = Simulator(model, seed=args.seed, default_neuron_type=neuron_type,
                    progress=True, device=device)
    if backend != "numpy":
        # tabulate inputs + capture the step's graphs OUTSIDE the timed
        # region
        n_run_steps = int(round(T / dt))
        sim.preload_inputs(n_run_steps)
        t0c = time.time()
        sim.compile(n_run_steps)
        print(f"compile: {time.time() - t0c:.1f}s")
    getter, elapsed_time, elapsed_thread_time = run_with_backend(
        sim, backend, T)
    pi_out_full = getter(ssp_p)
    print(f"sim wall time: {elapsed_time:.2f}s "
          f"({pi_out_full.shape[0] / elapsed_time:.0f} steps/s)")

    skip = 100 if path.shape[0] > 100000 else 1
    pi_sim_out = pi_out_full[::skip]
    ts = dt * np.arange(1, pathlen + 1)[::skip]
    path_s = path[::skip]
    real_s = ssp_space.encode(path[::skip])
    sim_path_est = decode_output(ssp_space, pi_sim_out, domain_dim,
                                 grid=100 if domain_dim < 3 else 50,
                                 device=device)
    pi_sims = np.sum(pi_sim_out * real_s, axis=1) / np.maximum(
        np.linalg.norm(pi_sim_out, axis=1), 1e-6)
    pi_error = np.sqrt(np.sum((path_s - sim_path_est) ** 2, axis=1))
    print(f"final distance error: {pi_error[-1]:.3f}; "
          f"median: {np.median(pi_error):.3f}")

    if args.save:
        if args.approx_vel:
            vel_est = getter(vel_p)
            n = min(len(vel_est), len(vels_scaled))
            sig_to_noise_ratio = 10 * np.log10(
                np.var(vels_scaled[:n])
                / np.var(vels_scaled[:n] - vel_est[:n]))
        else:
            sig_to_noise_ratio = np.nan
        extra = args.save_name_extra
        if args.domain_dim != 2:
            extra = "_dim_" + str(args.domain_dim)
        if backend == "numpy":
            extra = "_backend_numpy" + extra
        if device != "cpu":
            extra = "_device_" + device + extra
        if args.approx_vel:
            extra += f"_velnneurons_{args.vel_n_neurons}"
        filename = (f"pi{extra}_sspdim_{d}_pinneurons_{args.pi_n_neurons}"
                    f"_T_{int(T)}_limit_{args.limit}_seed_{args.seed}.npz")
        save_npz(args, filename, ts=ts, path=path_s, real_ssp=real_s,
                 pi_sim_out=pi_sim_out, pi_sims=pi_sims,
                 pi_path=sim_path_est, pi_error=pi_error,
                 elapsed_time=elapsed_time,
                 elapsed_thread_time=elapsed_thread_time,
                 sig_to_noise_ratio=sig_to_noise_ratio)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(5.5, 4))
        spec = fig.add_gridspec(3, 2)
        ax0 = fig.add_subplot(spec[0, :])
        ax0.plot(ts, 1 - pi_sims)
        ax0.set_ylabel("Cosine Error"); ax0.set_xlabel("Time (s)")
        ax0.set_xlim([0, T])
        ax1 = fig.add_subplot(spec[1, :])
        ax1.plot(ts, pi_error)
        ax1.set_ylabel("Distance Error"); ax1.set_xlabel("Time (s)")
        ax1.set_xlim([0, T])
        for j, axn in enumerate([fig.add_subplot(spec[2, 0]),
                                 fig.add_subplot(spec[2, 1])][:domain_dim]):
            axn.plot(ts, path_s[:, j], color="gray")
            axn.plot(ts, sim_path_est[:, j], "--", color="k")
            axn.set_xlim([0, T]); axn.set_xlabel("Time (s)")
            axn.set_ylabel("xy"[j] if j < 2 else f"x{j}")
        fig.suptitle("PI output")
        os.makedirs("figures", exist_ok=True)
        out = os.path.join("figures", f"pi_{args.seed}.png")
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
