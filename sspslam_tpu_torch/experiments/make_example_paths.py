"""Example trajectory files on the port: the arrays, flags and printed line
of the JAX package's ``experiments/make_example_paths.py`` (NumPy only, so
a copy): smooth room-constrained random walks at a coarse dt, resampled by
the run scripts' ``--path-data`` / ``--data-dt`` flags.

    python -m sspslam_tpu_torch.experiments.make_example_paths \
        [--out-dir example_paths] [--seed 0]
"""

import argparse
import os

import numpy as np


def two_rooms_path(n_steps=60000, dt=0.001, seed=0):
    """Smooth random walk in a two-room layout: x in [0, 2], y in [0, 1],
    with a dividing wall at x=1 pierced by a door at y in [0.4, 0.6]."""
    rng = np.random.default_rng(seed)
    pos = np.array([0.5, 0.5])
    vel = np.zeros(2)
    out = np.zeros((n_steps, 2))
    door = (0.4, 0.6)
    for i in range(n_steps):
        vel = 0.995 * vel + 0.02 * rng.normal(size=2)
        speed = np.linalg.norm(vel)
        if speed > 0.6:
            vel *= 0.6 / speed
        nxt = pos + vel * dt * 15
        # outer walls
        for j, (lo, hi) in enumerate([(0.02, 1.98), (0.02, 0.98)]):
            if not (lo <= nxt[j] <= hi):
                vel[j] = -vel[j]
                nxt[j] = np.clip(nxt[j], lo, hi)
        # dividing wall at x = 1 except the door
        crosses = (pos[0] - 1.0) * (nxt[0] - 1.0) < 0
        if crosses and not (door[0] <= nxt[1] <= door[1]):
            vel[0] = -vel[0]
            nxt[0] = pos[0]
        pos = nxt
        out[i] = pos
    return out


def one_room_path(n_steps=50000, dt=0.001, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.array([0.5, 0.5])
    vel = np.zeros(2)
    out = np.zeros((n_steps, 2))
    for i in range(n_steps):
        vel = 0.995 * vel + 0.02 * rng.normal(size=2)
        nxt = pos + vel * dt * 15
        for j in range(2):
            if not (0.02 <= nxt[j] <= 0.98):
                vel[j] = -vel[j]
                nxt[j] = np.clip(nxt[j], 0.02, 0.98)
        pos = nxt
        out[i] = pos
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="example_paths")
    ap.add_argument("--seed", default=0, type=int)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "twoRooms_path.npy"),
            two_rooms_path(seed=args.seed))
    np.save(os.path.join(args.out_dir, "oneRoom_path.npy"),
            one_room_path(seed=args.seed))
    print(f"wrote twoRooms_path.npy / oneRoom_path.npy to {args.out_dir}")


if __name__ == "__main__":
    main()
