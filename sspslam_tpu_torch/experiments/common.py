"""Shared experiment-script machinery: CLI flags, path generation, the SSP
space, decoding and npz saving.

A copy of the parts of the JAX package's ``experiments/common.py`` that
the port's CLIs use (that module imports the JAX package).
``--device`` (default ``cuda``) replaces ``--backend``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..nef import WhiteSignal
from ..sspspace import HexagonalSSPSpace, RandomSSPSpace

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


def save_npz(args, filename, **arrays):
    os.makedirs(os.path.join(os.getcwd(), args.save_dir), exist_ok=True)
    path = os.path.join(os.getcwd(), args.save_dir, filename)
    np.savez(path, **arrays, args=np.array(vars(args), dtype=object))
    print(f"saved {path}")
