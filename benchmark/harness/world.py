"""The traffic generator: every world a mix asks for, made from the seed.

A mix file (``benchmark/traffic/<name>.json``) names its ``entry`` and the
parameters read here.  The same seed gives the same worlds; each episode
draws from its own stream, ``default_rng([seed, episode])``.
"""

from __future__ import annotations

import numpy as np

DT = 0.001


def model_seed(seed: int) -> int:
    """The seed the networks are built with: the run's seed folded into
    the 31 bits the builders' NumPy streams take."""
    return int(seed) % (2 ** 31)


def episode_rng(seed: int, episode: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(episode)])


def band_limited_path(rng: np.random.Generator, n_steps: int, limit: float,
                      dim: int = 2, radius: float = 1.0, dt=DT):
    """A band-limited white-noise path (cut-off ``limit`` Hz, one signal
    per axis), rescaled into [-0.9 r, 0.9 r] per axis, and its velocities:
    ``run_pathint``'s path."""
    n_coeffs = n_steps // 2 + 1
    freqs = np.fft.rfftfreq(n_steps, d=dt)
    coeffs = (rng.standard_normal((n_coeffs, dim))
              + 1j * rng.standard_normal((n_coeffs, dim)))
    coeffs[0] = 0.0
    coeffs[freqs > limit] = 0.0
    if n_steps % 2 == 0:
        coeffs[-1] = coeffs[-1].real
    path = np.fft.irfft(coeffs, n=n_steps, axis=0)
    lo, hi = path.min(axis=0), path.max(axis=0)
    path = (path - lo) / np.maximum(hi - lo, 1e-12) * 1.8 * radius \
        - 0.9 * radius
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    return path, vels


def pi_episode(mix: dict, seed: int, episode: int):
    """One path-integration episode: its path and velocities."""
    n = int(round(mix["episode_s"] / DT))
    return band_limited_path(episode_rng(seed, episode), n, mix["limit"])
