"""Full SSP-SLAM CLI on the port: the flags, metrics, learned-map
extraction, npz schema and printed lines of the JAX package's
``experiments/run_slam.py``, with ``--device`` (default ``cuda``) naming
where the simulation runs.

    python -m sspslam_tpu_torch.experiments.run_slam [--device cpu] \
        [--backend jit|cpu|numpy|gated] ...

``--backend jit`` (default) builds ``SLAMNetwork`` and steps it with the
port's :class:`Simulator` (CUDA graphs on the card); ``cpu`` is the same
on ``--device cpu``; ``numpy`` runs the NumPy interpreter
(:class:`nef.reference_backend.NumpyStepper`) on the host over the model
built on ``--device`` (with ``--device cpu`` it needs no card);
``gated`` builds the all-neural ``SLAMGatedNetwork`` (no learned-map
extraction, as in the JAX CLI).  ``--plot`` writes
``figures/slam_<backend>.png`` (imports matplotlib).
"""

import argparse
import os
import time

import numpy as np

from ..models import (SLAMGatedNetwork, SLAMNetwork,
                      get_slam_input_functions, get_slam_input_functions2)
from ..nef import (LIF, Connection, Ensemble, LIFRate, LoihiLIF, Network,
                   Node, Probe, QuantizedLIF, RectifiedLinear, Simulator)
from ..sspspace import SPSpace
from ..utils import Rd_sampling
from ..utils.profiling import print_utilization_summary
from .common import (DT, add_common_args, decode_output, make_path,
                     make_space, run_with_backend, save_npz)


BACKENDS = {"jit": "jit", "ocl": "jit", "tpu": "jit", "cpu": "cpu",
            "numpy": "numpy", "gated": "gated", "loihi": "gated",
            "loihi-sim": "gated"}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SSP-SLAM on the port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=200.0)
    parser.add_argument("--backend", default="jit",
                        help="jit: SLAMNetwork on --device; cpu: the same "
                             "on the CPU; numpy: the NumPy interpreter on "
                             "the host; gated: the all-neural "
                             "SLAMGatedNetwork on --device")
    parser.add_argument("--n-landmarks", default=50, type=int)
    parser.add_argument("--view-rad", default=0.2, type=float)
    parser.add_argument("--update-thres", default=0.2, type=float)
    parser.add_argument("--shift-rate", default=0.2, type=float)
    parser.add_argument("--intercept", default=0.1, type=float)
    parser.add_argument("--tuned", action="store_true",
                        help="apply the tuned loop-closure config of the "
                             "JAX package's experiments/tune_loop_closure.py"
                             ": update_thres 0.4, shift_rate 0.1, pes_lr "
                             "2e-2, voja_lr 1e-4, intercept 0.3")
    parser.add_argument("--voja-lr", default=1e-4, type=float)
    parser.add_argument("--pes-lr", default=5e-3, type=float)
    parser.add_argument("--pi-n-neurons", default=800, type=int)
    parser.add_argument("--mem-n-neurons", default=970, type=int)
    parser.add_argument("--circonv-n-neurons", default=100, type=int)
    parser.add_argument("--gc-n-neurons", default=0, type=int)
    parser.add_argument("--no-voja", action="store_true")
    parser.add_argument("--no-cleanup", action="store_true")
    parser.add_argument("--single-obj", action="store_true")
    parser.add_argument("--approx-vel", action="store_true")
    parser.add_argument("--vel-n-neurons", default=500, type=int)
    parser.add_argument("--neuron-type", default="lif",
                        help="lif | loihi | quantized (model-wide default; "
                             "loihi = dt-grid Loihi-discretised LIF)")
    args = parser.parse_args(argv)
    backend = args.backend.lower()
    if backend not in BACKENDS:
        raise SystemExit(f"unknown backend {args.backend!r}")
    backend = BACKENDS[backend]
    if args.tuned:
        args.update_thres, args.shift_rate = 0.4, 0.1
        args.pes_lr, args.voja_lr, args.intercept = 2e-2, 1e-4, 0.3
    device = "cpu" if backend == "cpu" else args.device

    dt = DT
    tau = 0.05
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=99999)
    pathlen = path.shape[0]

    view_rad = args.view_rad
    n_landmarks = args.n_landmarks
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(n_landmarks, domain_dim, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]

    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    # encode only the rows the init clamp reads
    real_init = ssp_space.encode(path[:60])
    lm_space = SPSpace(n_landmarks, d, seed=args.seed)

    get_fns = (get_slam_input_functions if args.single_obj
               else get_slam_input_functions2)
    (velocity_func, vel_scaling_factor, is_landmark_in_view, _,
     landmark_sp_func, _, landmark_vecssp_func) = get_fns(
        ssp_space, lm_space, vels, vec_to_landmarks, view_rad)

    with Network(seed=args.seed) as model:
        if args.approx_vel:
            vel_syn = 0.01
            _vel_input = Node(velocity_func, label="vel_input")
            vel_input = Ensemble(args.vel_n_neurons, domain_dim)
            Connection(_vel_input, vel_input, synapse=None)
            vel_p = Probe(vel_input, synapse=vel_syn)
            _vel_p = Probe(_vel_input, synapse=None)
        else:
            vel_syn = None
            vel_input = Node(velocity_func, label="vel_input")
        init_state = Node(lambda t: real_init[min(int((t - dt) / dt), 59)]
                          if t < 0.05 else np.zeros(d), label="init_state")
        landmark_vec = Node(landmark_vecssp_func, label="lm_vecssp_input")
        landmark_id = Node(landmark_sp_func, label="lm_sp_input")
        is_landmark = Node(is_landmark_in_view, label="lm_in_view_input")

        if backend == "gated":
            slam = SLAMGatedNetwork(
                ssp_space, lm_space, view_rad, n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons, args.circonv_n_neurons,
                vel_input, landmark_vec, landmark_id, is_landmark,
                tau_pi=tau, update_thres=args.update_thres,
                vel_scaling_factor=vel_scaling_factor,
                shift_rate=0.1, pes_learning_rate=1e-3, seed=args.seed)
        else:
            slam = SLAMNetwork(
                ssp_space, lm_space, view_rad, n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons,
                tau_pi=tau, update_thres=args.update_thres,
                vel_scaling_factor=vel_scaling_factor,
                shift_rate=args.shift_rate, voja_learning_rate=args.voja_lr,
                pes_learning_rate=args.pes_lr, intercept=args.intercept,
                clean_up_method=None if args.no_cleanup else "grid",
                gc_n_neurons=args.gc_n_neurons,
                voja=not args.no_voja, seed=args.seed)
            Connection(landmark_vec, slam.landmark_vec_ssp, synapse=None)
            Connection(landmark_id, slam.landmark_id_input, synapse=None)
            Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
            Connection(vel_input, slam.velocity_input, synapse=vel_syn)
        Connection(init_state, slam.pathintegrator.input, synapse=None)

        slam_output_p = Probe(slam.pathintegrator.output, synapse=0.05)
        if args.save and backend != "gated":
            mem_weights = Probe(slam.assomemory.conn_out, attr="weights",
                                sample_every=T)
            if not args.no_voja:
                mem_encoders = Probe(slam.assomemory.conn_in.learning_rule,
                                     attr="scaled_encoders", sample_every=T)

    neuron_type = {"lif": LIF(), "lifrate": LIFRate(),
                   "relu": RectifiedLinear(), "loihi": LoihiLIF(),
                   "quantized": QuantizedLIF()}[args.neuron_type]
    sim = Simulator(model, seed=args.seed, progress=True,
                    default_neuron_type=neuron_type, device=device)
    print_utilization_summary(sim.model)
    if backend == "numpy":
        getter, elapsed_time, elapsed_thread_time = run_with_backend(
            sim, "numpy", T)
    else:
        # tabulate inputs + capture the step's graphs OUTSIDE the timed
        # region
        n_run_steps = int(round(T / dt))
        sim.preload_inputs(n_run_steps)
        t0c = time.time()
        sim.compile(n_run_steps)
        print(f"compile: {time.time() - t0c:.1f}s")
        getter, elapsed_time, elapsed_thread_time = run_with_backend(
            sim, backend, T)
    slam_out_full = getter(slam_output_p)
    print(f"sim wall time: {elapsed_time:.2f}s "
          f"({slam_out_full.shape[0] / elapsed_time:.0f} steps/s)")

    skip = 100 if path.shape[0] > 100000 else 1
    slam_sim_out = slam_out_full[::skip]
    ts = dt * np.arange(1, pathlen + 1)[::skip]
    path_s = path[::skip]
    real_s = ssp_space.encode(path[::skip])
    sim_path_est = decode_output(ssp_space, slam_sim_out, domain_dim,
                                 device=device)
    slam_sims = np.sum(slam_sim_out * real_s, axis=1) / np.maximum(
        1e-6, np.linalg.norm(slam_sim_out, axis=1))
    slam_error = np.sqrt(np.sum((path_s - sim_path_est) ** 2, axis=1))
    print(f"final distance error: {slam_error[-1]:.3f}; "
          f"median: {np.median(slam_error):.3f}")

    if args.save:
        if args.approx_vel:
            v_in = getter(_vel_p)
            v_est = getter(vel_p)
            sig_to_noise_ratio = 10 * np.log10(
                np.var(v_in) / np.var(v_in - v_est))
        else:
            sig_to_noise_ratio = 0

        if backend != "gated":
            # learned-map extraction: the final PES decoders times the
            # memory's rates on the landmark SPs, through the final
            # (probed) Voja encoders
            decoders = getter(mem_weights)[-1].T          # (n, d)
            be = next(b for b in sim.model.ensembles
                      if b.obj is slam.assomemory.memory)
            if not args.no_voja:
                scaled_enc = getter(mem_encoders)[-1]
            else:
                scaled_enc = be.scaled_encoders
            J = lm_space.vectors @ scaled_enc.T + be.bias
            activities = be.neuron_type.rates_np(J)
            landmark_ssps_est = activities @ decoders
            landmark_loc_est = decode_output(ssp_space, landmark_ssps_est,
                                             domain_dim, device=device)
            map_err = np.linalg.norm(landmark_loc_est - obj_locs, axis=1)
            print(f"learned-map median landmark error: "
                  f"{np.median(map_err):.3f}")
        else:
            landmark_ssps_est = np.array([])
            landmark_loc_est = np.array([])

        extra = args.save_name_extra
        if args.domain_dim != 2:
            extra = "_dim_" + str(args.domain_dim)
        if backend in ("gated", "numpy"):
            extra = "_backend_" + backend + extra
        if device != "cpu":
            extra = "_device_" + device + extra
        if args.approx_vel:
            extra += f"_velnneurons_{args.vel_n_neurons}"
        filename = (f"slam_{extra}_sspdim_{d}_pinneurons_{args.pi_n_neurons}"
                    f"_memnneurons_{args.mem_n_neurons}"
                    f"_ccnneurons_{args.circonv_n_neurons}"
                    f"_T_{int(T)}_limit_{args.limit}_seed_{args.seed}.npz")
        save_npz(args, filename,
                 timesteps=np.arange(0, T, dt), ts=ts, path=path_s,
                 real_ssp=real_s, obj_locs=obj_locs, view_rad=view_rad,
                 slam_sim_out=slam_sim_out, slam_sims=slam_sims,
                 slam_path=sim_path_est, slam_error=slam_error,
                 landmark_ssps_est=landmark_ssps_est,
                 landmark_loc_est=landmark_loc_est,
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
        ax0.plot(ts, 1 - slam_sims)
        ax0.set_ylabel("Cosine Error"); ax0.set_xlabel("Time (s)")
        ax1 = fig.add_subplot(spec[1, :])
        ax1.plot(ts, slam_error)
        ax1.set_ylabel("Distance Error"); ax1.set_xlabel("Time (s)")
        for j in range(min(2, domain_dim)):
            axn = fig.add_subplot(spec[2, j])
            axn.plot(ts, path_s[:, j], color="gray")
            axn.plot(ts, sim_path_est[:, j], "--", color="k")
            axn.set_xlabel("Time (s)"); axn.set_ylabel("xy"[j])
        fig.suptitle("SLAM output")
        os.makedirs("figures", exist_ok=True)
        out = os.path.join("figures", f"slam_{backend}.png")
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
