"""Tracking of bench.py --model slam's world by the JAX package and by the
port, both on the CPU, from the same seed: the mean over the last quarter
of the 14 s world of cos(PI output, encode(path)), as bench.py computes it.

    JAX_PLATFORMS=cpu python tests/torch_slam_tracking.py [--pi-n-neurons N]
        [--mem-n-neurons N] [--circonv-n-neurons N] [--cleanup-samples N]

The defaults are a reduced width (ssp_dim 97, 200 LIF per VCO, memory 300,
30 neurons per circular-convolution dimension, clean-up over 50 x 50
samples in bf16); pass bench.py's own (800, 970, 100, 100) for the full
width, which needs a large host.  Prints one JSON line.  An accuracy, not
a time: the card's figure at full width is chip_smoke.py's phase 11.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def world(seed=0, steps=14_000, n_landmarks=10):
    """bench.py ``build``'s path, velocities and landmarks."""
    dt = 0.001
    ts = dt * np.arange(steps)
    T = steps * dt
    path = 0.8 * np.stack([np.sin(2 * np.pi * ts / T),
                           np.cos(4 * np.pi * ts / T)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(seed).uniform(-0.7, 0.7,
                                                    (n_landmarks, 2))
    return path, vels, landmarks[None, :, :] - path[:, None, :]


def tracking(pkg, args, device=None):
    """Build bench.py's SLAM network with package ``pkg`` (the JAX package
    or the port), run the world once and return (cosine, seconds)."""
    models = __import__(f"{pkg}.models", fromlist=["x"])
    nef = __import__(f"{pkg}.nef", fromlist=["x"])
    top = __import__(pkg)
    path, vels, vec = world(args.seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = top.HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                                  length_scale=0.3, domain_bounds=bounds)
    lm_space = top.SPSpace(10, space.ssp_dim, seed=args.seed)
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        models.get_slam_input_functions(space, lm_space, vels, vec, 0.8)
    with nef.Network(seed=args.seed) as net:
        slam = models.SLAMNetwork(
            space, lm_space, 0.8, 10, pi_n_neurons=args.pi_n_neurons,
            mem_n_neurons=args.mem_n_neurons,
            circonv_n_neurons=args.circonv_n_neurons,
            vel_scaling_factor=scale,
            cleanup_samples_per_dim=args.cleanup_samples, seed=args.seed)
        for f, dst in ((vel_f, slam.velocity_input),
                       (nef.clamp_table(space.encode(path[:1]).ravel(), 0.05),
                        slam.pathintegrator.input),
                       (sp_f, slam.landmark_id_input),
                       (vecssp_f, slam.landmark_vec_ssp),
                       (in_view_f, slam.no_landmark_in_view)):
            nef.Connection(nef.Node(f), dst, synapse=None)
        probe = nef.Probe(slam.pathintegrator.output, synapse=0.05)
    kw = {} if device is None else {"device": device}
    t0 = time.perf_counter()
    sim = nef.Simulator(net, seed=args.seed, **kw)
    sim.run_steps(len(path))
    out = np.asarray(sim.data[probe])
    real = space.encode(path)
    sims = np.sum(out * real, axis=1) / np.maximum(
        np.linalg.norm(out, axis=1), 1e-9)
    return float(np.mean(sims[-len(path) // 4:])), time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=200)
    ap.add_argument("--mem-n-neurons", type=int, default=300)
    ap.add_argument("--circonv-n-neurons", type=int, default=30)
    ap.add_argument("--cleanup-samples", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch
    torch.set_num_threads(1)
    out = {"widths": vars(args)}
    for pkg, device in (("sspslam_tpu", None), ("sspslam_tpu_torch", "cpu")):
        cos, seconds = tracking(pkg, args, device)
        out[pkg] = {"tracking_cosine": cos, "cpu_seconds": seconds}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
