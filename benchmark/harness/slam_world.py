"""The SLAM cells' world: one ``run_slam.py`` world per run, made from the
seed.

A 0.1 Hz band-limited path of ``world_s`` seconds at dt 1 ms in [-0.9, 0.9]²
(``world.band_limited_path``, the stream ``default_rng([seed, 0])``),
``n_landmarks`` landmarks at run_slam.py's places (Roberts' R_d sequence
scaled into [-0.9, 0.9]², which run_slam.py draws for every seed alike),
and the view radius that decides which landmarks are seen.  Both the
entry (for the program's input nodes) and the reference (for its own
input rows) read the world from here; neither takes the other's rows.
"""

from __future__ import annotations

import numpy as np

from . import world as W

DT = W.DT


def rd_points(n: int, dim: int, offset: float = 0.5) -> np.ndarray:
    """The first ``n`` points of Roberts' R_d sequence in [0, 1)^dim:
    (offset + i alpha) mod 1, alpha the powers of 1 / g, g^(dim + 1) =
    g + 1."""
    g = 2.0
    for _ in range(30):
        g = (1 + g) ** (1.0 / (dim + 1))
    alpha = (1.0 / g) ** np.arange(1, dim + 1) % 1
    return (offset + alpha[None, :] * np.arange(1, n + 1)[:, None]) % 1


def steps(mix: dict) -> int:
    return int(round(mix["world_s"] / DT))


def path(mix: dict, seed: int):
    """(path (T, 2), velocities (T, 2)) of the run's world."""
    return W.band_limited_path(W.episode_rng(seed, 0), steps(mix),
                               mix["limit"])


def landmarks(cfg: dict, offset=0.5) -> np.ndarray:
    """(L, 2) landmark places: run_slam.py's 0.9 r 2 (R_d - 0.5)."""
    r = cfg["domain_bound"]
    return 0.9 * r * 2 * (rd_points(cfg["n_landmarks"], cfg["domain_dim"],
                                    offset) - 0.5)


def in_view(cfg: dict, p: np.ndarray, obj: np.ndarray) -> np.ndarray:
    """(T, L) whether each landmark lies within the view radius of each
    row of ``p``."""
    dist = np.linalg.norm(obj[None, :, :] - p[:, None, :], axis=2)
    return dist <= cfg["view_rad"]
