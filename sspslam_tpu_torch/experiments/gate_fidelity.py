"""Gate-fidelity evidence for the all-neural SLAMGatedNetwork on the port:
the configurations, flags and printed table of the JAX package's
``experiments/gate_fidelity.py``, with ``--device`` (default ``cuda``).

The reference's Loihi model gates its correction ensemble with a threshold
population representing ``1 + no_view - dot(est, PI)`` that INHIBITS the
correction when it exceeds ``update_thres``: the correction engages only
when ``dot > 1 - update_thres``, whereas SLAMNetwork's node gate engages
when ``dot > update_thres``.  With the shared CLI default 0.2 the two
models run at effective thresholds 0.8 and 0.2.  Run with rate neurons
(LIFRate) and the same seeds: the faithful 'loihi' gate at 0.2 almost
never engages and drifts like a bare path integrator, while the same
wiring at 0.8 (or ``gate_semantics='matched'`` at 0.2) tracks.

    python -m sspslam_tpu_torch.experiments.gate_fidelity [--T 20] \
        [--device cpu]
"""

import argparse

import numpy as np

from ..models import SLAMGatedNetwork, get_slam_input_functions
from ..nef import Connection, LIFRate, Network, Node, Probe, Simulator
from ..sspspace import HexagonalSSPSpace, SPSpace


def run_config(args, gate_semantics, update_thres):
    """Median decoded error over the last three quarters and the fraction
    of steps (after the first tenth) at which the gate is engaged."""
    dt = 0.001
    seed = args.seed
    rng = np.random.default_rng(seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    n_steps = int(args.T / dt)
    ts = dt * np.arange(n_steps)
    path = 0.7 * np.stack([np.sin(2 * np.pi * ts / args.T),
                           np.cos(4 * np.pi * ts / args.T)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = rng.uniform(-0.6, 0.6, size=(args.n_landmarks, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=seed)
    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.6)
    ssp0 = space.encode(path[:1]).flatten()

    with Network(seed=seed) as net:
        vel = Node(velocity_func)
        init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMGatedNetwork(
            space, lm_space, 0.6, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons, args.circonv_n_neurons,
            args.circonv_n_neurons, vel, lm_ssp, lm_id, in_view,
            tau_pi=0.05, update_thres=update_thres,
            vel_scaling_factor=scale, shift_rate=0.1,
            pes_learning_rate=1e-3, seed=seed,
            gate_semantics=gate_semantics)
        Connection(init, slam.pathintegrator.input, synapse=None)
        p_out = Probe(slam.pathintegrator.output, synapse=0.05)
        p_thr = Probe(slam.threshold, synapse=0.02)

    sim = Simulator(net, seed=seed, default_neuron_type=LIFRate(),
                    device=args.device)
    sim.run(args.T)
    out = sim.data[p_out]
    thr = sim.data[p_thr][:, 0]

    stride = max(1, n_steps // 400)
    dec = space.decode(out[::stride], "from-set", "grid", 50,
                       device=args.device)
    err = np.linalg.norm(dec - path[::stride], axis=1)
    # gate engaged when the threshold population is (near) silent
    engaged = float(np.mean(thr[n_steps // 10:] < 0.05))
    return float(np.median(err[len(err) // 4:])), engaged


CONFIGS = [
    ("loihi", 0.2, "faithful reference wiring @ CLI default 0.2 "
                   "(effective dot-threshold 0.8)"),
    ("loihi", 0.8, "faithful wiring @ 0.8 (effective dot-threshold 0.2)"),
    ("matched", 0.2, "matched semantics @ 0.2 (same effective threshold)"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=20.0)
    ap.add_argument("--ssp-dim", type=int, default=31)
    ap.add_argument("--pi-n-neurons", type=int, default=120)
    ap.add_argument("--mem-n-neurons", type=int, default=250)
    ap.add_argument("--circonv-n-neurons", type=int, default=60)
    ap.add_argument("--n-landmarks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the simulation runs on (cuda | cpu)")
    args = ap.parse_args(argv)

    print(f"{'gate':8} {'thres':6} {'median err':>10} {'engaged frac':>13}")
    rows = []
    for sem, thres, desc in CONFIGS:
        err, engaged = run_config(args, sem, thres)
        print(f"{sem:8} {thres:<6} {err:>10.3f} {engaged:>13.3f}   # {desc}")
        rows.append((sem, thres, err, engaged))
    return rows


if __name__ == "__main__":
    main()
