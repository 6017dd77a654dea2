"""Shared experiment-script machinery: CLI flags, path generation, the SSP
space, decoding, npz saving, running a built model on a backend, and
``bench.py --model slam``'s world and network.

A copy of the parts of the JAX package's ``experiments/common.py`` that
the port's CLIs use (that module imports the JAX package).
``--device`` (default ``cuda``) names where the simulation runs; the CLIs
that take ``--backend`` add it themselves.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..nef import WhiteSignal
from ..sspspace import HexagonalSSPSpace, RandomSSPSpace, SPSpace

DT = 0.001


def add_common_args(parser: argparse.ArgumentParser, default_T=20.0):
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device the simulation runs on "
                             "(cuda | cpu)")
    parser.add_argument("--path-data", default=None, type=str,
                        help="Path to a .npy (n_timesteps x domain_dim) "
                             "trajectory; random WhiteSignal path if omitted")
    parser.add_argument("--data-dt", default=0.001, type=float)
    parser.add_argument("--domain-dim", default=2, type=int)
    parser.add_argument("--limit", default=0.1, type=float,
                        help="Max frequency content of the random path (Hz)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--T", default=default_T, type=float)
    parser.add_argument("--ssp-dim", default=97, type=int)
    parser.add_argument("--n-scales", default=0, type=int)
    parser.add_argument("--n-rotates", default=3, type=int)
    parser.add_argument("--use-rand", action="store_true")
    parser.add_argument("--length-scale", default=0.2, type=float)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--save-plot", action="store_true")
    parser.add_argument("--save-dir", default="data")
    parser.add_argument("--save-name-extra", default="")


def stretch_trajectory(traj, original_dt=0.02, new_dt=0.001):
    """Linear-interpolate a trajectory onto the simulation dt (reference
    run_pathint.py:57-66)."""
    n_steps = traj.shape[0]
    total_time = n_steps * original_dt
    n_timesteps = int(total_time / new_dt)
    t_orig = np.linspace(0, total_time, n_steps)
    t_new = np.linspace(0, total_time, n_timesteps)
    out = np.zeros((n_timesteps, traj.shape[1]))
    for i in range(traj.shape[1]):
        out[:, i] = np.interp(t_new, t_orig, traj[:, i])
    return out


def make_path(args, radius=1.0, max_steps=None):
    """Random band-limited path or loaded .npy, rescaled into
    [-0.9 r, 0.9 r]; returns (path, vels, T, domain_dim)."""
    dt = DT
    if args.path_data is None:
        T = args.T
        domain_dim = args.domain_dim
        path = np.hstack([
            WhiteSignal(T, high=args.limit, seed=args.seed + i).run(T, dt=dt)
            for i in range(domain_dim)])
    else:
        path = np.load(os.path.join(os.getcwd(), args.path_data))
        if max_steps:
            path = path[:max_steps]
        if args.data_dt != dt:
            path = stretch_trajectory(path, original_dt=args.data_dt,
                                      new_dt=dt)
        T = path.shape[0] * dt
        domain_dim = path.shape[1]

    for i in range(path.shape[1]):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * 1.8 * radius - 0.9 * radius)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    return path, vels, T, domain_dim


def make_space(args, domain_dim, radius=1.0):
    bounds = radius * np.tile([-1, 1], (domain_dim, 1))
    if args.use_rand:
        return RandomSSPSpace(
            domain_dim, ssp_dim=args.ssp_dim, domain_bounds=bounds,
            length_scale=args.length_scale, seed=args.seed)
    if args.n_scales > 0:
        return HexagonalSSPSpace(
            domain_dim, n_scales=args.n_scales, n_rotates=args.n_rotates,
            domain_bounds=bounds, length_scale=args.length_scale,
            seed=args.seed)
    return HexagonalSSPSpace(
        domain_dim, ssp_dim=args.ssp_dim, domain_bounds=bounds,
        length_scale=args.length_scale, seed=args.seed)


def decode_output(ssp_space, data, domain_dim, grid=None,
                  method="from-set", *, device):
    """Decode SSP rows to domain points by argmax over a grid sample bank
    (from-set), the similarity matmul on ``device``."""
    grid = grid if grid is not None else (100 if domain_dim < 3 else 30)
    return ssp_space.decode(data, method, "grid", grid, device=device)


def kernel_value(space, r, M=200, seed=0):
    """Mean SSP similarity K(r) = cos(phi(x), phi(x + r u)) over random
    points and directions: the space's own distance -> similarity map,
    from which the gate thresholds are derived (trigger = K(view_rad))."""
    rng = np.random.default_rng(seed)
    dim = space.domain_dim
    u = rng.standard_normal((M, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = rng.uniform(-0.5, 0.5, (M, dim))
    a = np.asarray(space.encode(x))
    b = np.asarray(space.encode(x + r * u))
    cs = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                  * np.linalg.norm(b, axis=1))
    return float(np.mean(cs))


def learned_base(sim):
    """The model's initial learned leaves (PES decoders, Voja encoders) as
    float32 tensors on ``sim``'s device: the base a map merge or exchange
    adds its deltas to."""
    def f32(x):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return torch.as_tensor(np.asarray(x, np.float32)).to(sim.device)
    return {k: f32(v) for k, v in sim.model.learned_init.items()}


def save_npz(args, filename, **arrays):
    os.makedirs(os.path.join(os.getcwd(), args.save_dir), exist_ok=True)
    path = os.path.join(os.getcwd(), args.save_dir, filename)
    np.savez(path, **arrays, args=np.array(vars(args), dtype=object))
    print(f"saved {path}")


def run_with_backend(sim, backend, T):
    """Run ``sim``'s model for ``T`` seconds on ``backend``: the Simulator
    itself (``jit``, ``gated``, ``cpu``: on the device it was built for) or
    the NumPy interpreter (``numpy``, on the host whatever that device).
    Returns (probe getter, elapsed seconds, elapsed thread seconds).  The
    interpreter's getter reads a sparse probe (a weights or encoders
    snapshot) from its final state."""
    from ..nef.reference_backend import NumpyStepper
    if backend != "numpy":
        t0t = time.thread_time()
        t0 = time.time()
        sim.run(T)
        sim.sync()
        return (sim.data.__getitem__, time.time() - t0,
                time.thread_time() - t0t)
    n_steps = int(round(T / sim.dt))
    tables = [np.asarray(c) for c in sim._tabulate_inputs(n_steps)]
    stepper = NumpyStepper(sim.model)
    t0t = time.thread_time()
    t0 = time.time()
    out = stepper.run_steps(n_steps, tables)
    elapsed, elapsed_t = time.time() - t0, time.thread_time() - t0t

    def getter(probe):
        bp = next(p for p in sim.model.probes if p.obj is probe)
        if bp.sparse:
            return stepper.sparse_probe(bp)[None]
        return out[bp.index]

    return getter, elapsed, elapsed_t


# -- bench.py --model slam's world and network (the flagship) ---------------
def slam_world(world_T=14.0, n_landmarks=10, seed=0):
    """bench.py --model slam's world: the figure-eight path of ``world_T``
    seconds, its velocities, ``n_landmarks`` landmarks drawn from ``seed``
    and the (steps, landmarks, 2) vectors to them."""
    ts = DT * np.arange(int(round(world_T / DT)))
    path = 0.8 * np.stack([np.sin(2 * np.pi * ts / world_T),
                           np.cos(4 * np.pi * ts / world_T)], axis=1)
    vels = (1 / DT) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = np.random.default_rng(seed).uniform(
        -0.7, 0.7, size=(n_landmarks, 2))
    return path, vels, landmarks, landmarks[None, :, :] - path[:, None, :]


def slam_inputs(space, lm_space, world, view_rad=0.8):
    """bench.py --model slam's input functions for ``world`` through the
    single-nearest adapter, in the order :func:`slam_simulator` connects
    them (velocities, the initial clamp, landmark SP, landmark vector SSP,
    in-view flag), and the velocity scale."""
    from ..models import get_slam_input_functions
    from ..nef import clamp_table
    path, vels, _, vec = world
    (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec, view_rad)
    return [vel_f, clamp_table(space.encode(path[:1]).ravel(), 0.05), sp_f,
            vecssp_f, in_view_f], scale


def slam_simulator(space, world, gate_mode="reference", anchor=False,
                   clean_up_method="grid", matmul_dtype=None, *,
                   pi_n_neurons=800, mem_n_neurons=970, circonv_n_neurons=100,
                   cleanup_samples=100, view_rad=0.8, n_anchors=3, seed=0,
                   device="cuda", mesh=None):
    """bench.py --model slam's network: SLAMNetwork (by default at the
    flagship width: 800 LIF per VCO, memory 970, 100 neurons per
    circular-convolution dimension, clean-up over 100 x 100 samples) fed
    by :func:`slam_inputs` on ``world``, the PI output probed through a 50
    ms lowpass.  With ``anchor`` the auto-recovery gate reads the first
    ``n_anchors`` landmarks as surveyed beacons; ``clean_up_method`` picks
    the clean-up (the MLP ones read ``space.decoder_params``);
    ``matmul_dtype`` the parameter storage; ``mesh`` a model axis to
    shard the Simulator over.  Returns (simulator, probe, build
    seconds)."""
    from ..models import SLAMNetwork, get_anchor_input_functions
    from ..nef import Connection, Network, Node, Probe, Simulator
    path, vels, landmarks, vec = world
    n_landmarks = len(landmarks)
    lm_space = SPSpace(n_landmarks, space.ssp_dim, seed=seed)
    fns, scale = slam_inputs(space, lm_space, world, view_rad)
    with Network(seed=seed) as net:
        slam = SLAMNetwork(space, lm_space, view_rad, n_landmarks,
                           pi_n_neurons=pi_n_neurons,
                           mem_n_neurons=mem_n_neurons,
                           circonv_n_neurons=circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=cleanup_samples, seed=seed,
                           gate_mode=gate_mode, anchor=anchor,
                           clean_up_method=clean_up_method)
        for f, dst in zip(fns, (slam.velocity_input,
                                slam.pathintegrator.input,
                                slam.landmark_id_input,
                                slam.landmark_vec_ssp,
                                slam.no_landmark_in_view)):
            Connection(Node(f), dst, synapse=None)
        if anchor:
            tables = get_anchor_input_functions(
                space, vec, np.arange(n_anchors), landmarks[:n_anchors],
                view_rad)
            for f, dst in zip(tables, (slam.anchor_pos_input,
                                       slam.anchor_vec_ssp,
                                       slam.no_anchor_in_view)):
                Connection(Node(f), dst, synapse=None)
        probe = Probe(slam.pathintegrator.output, synapse=0.05)
    t0 = time.perf_counter()
    sim = Simulator(net, seed=seed, device=device, matmul_dtype=matmul_dtype,
                    mesh=mesh)
    return sim, probe, time.perf_counter() - t0
