"""Sampling / statistics utilities (NumPy/SciPy, build-time).

A copy of :mod:`sspslam_tpu.utils.sampling`: importing that module would run
``sspslam_tpu/__init__.py`` and pull in JAX.  Quasi-Monte-Carlo hypersphere
sampling (the R_d Kronecker sequence plus the inverse-CDF hyperspherical-
coordinate transform), intercept solving, and bootstrap confidence
intervals, implemented from the published algorithms (Roberts' R_d
sequence; inverse-transform sampling of hyperspherical coordinates via the
regularised incomplete beta function).  Same code, same RNG draws, so both
packages sample bitwise-equal parameters from one seed.
"""

from __future__ import annotations

import numpy as np
from scipy.special import betainc, betaincinv
from scipy.stats import special_ortho_group


def sparsity_to_x_intercept(d: int, p: float) -> float:
    """Intercept such that a fraction ``p`` of uniformly distributed unit
    vectors exceed it in dot product (reference utils.py:5-10)."""
    sign = 1
    if p > 0.5:
        p = 1.0 - p
        sign = -1
    return sign * np.sqrt(1 - betaincinv((d - 1) / 2.0, 0.5, 2 * p))


def get_mean_and_ci(raw_data, n=3000, p=0.95, rng=None):
    """Bootstrap mean and confidence interval per column of (sets, T) data
    (reference utils.py:13-38)."""
    raw = np.asarray(raw_data)
    rng = np.random.default_rng() if rng is None else rng
    sets, data_pts = raw.shape
    index = int(n * (1 - p) / 2)
    mean, lower, upper = [], [], []
    for i in range(data_pts):
        col = raw[:, i]
        boots = rng.choice(col, size=(n, sets)).mean(axis=1)
        boots.sort()
        mean.append(col.mean())
        lower.append(boots[index])
        upper.append(boots[-index - 1])
    return {"mean": mean, "lower_bound": lower, "upper_bound": upper}


def Rd_sampling(n: int, d: int, seed: float = 0.5) -> np.ndarray:
    """First ``n`` points of Roberts' R_d low-discrepancy sequence in [0,1)^d."""
    # g solves g^(d+1) = g + 1 (generalised golden ratio)
    g = 2.0
    for _ in range(30):
        g = (1 + g) ** (1.0 / (d + 1))
    alpha = (1.0 / g) ** (np.arange(1, d + 1)) % 1
    i = np.arange(1, n + 1)[:, None]
    return (seed + alpha[None, :] * i) % 1


def _spherical_ppf(m: int, y: np.ndarray) -> np.ndarray:
    """Inverse CDF of the m-th hyperspherical coordinate distribution
    (pdf proportional to sin^(m-1)(pi x) on [0, 1])."""
    y = np.asarray(y)
    y_reflect = np.where(y < 0.5, y, 1 - y)
    z_sq = betaincinv(m / 2.0, 0.5, 2 * y_reflect)
    x = np.arcsin(np.sqrt(z_sq)) / np.pi
    return np.where(y < 0.5, x, 1 - x)


def spherical_transform(samples: np.ndarray) -> np.ndarray:
    """Map (n, m) cube samples onto the unit sphere S^m in R^(m+1) via
    inverse-transform sampling of hyperspherical coordinates."""
    samples = np.atleast_2d(samples)
    n, d = samples.shape
    coords = np.empty_like(samples, dtype=np.float64)
    for j in range(d):
        coords[:, j] = _spherical_ppf(d - j, samples[:, j])
    # last angular coordinate spans the full circle
    mult = np.ones(d)
    mult[-1] = 2.0
    ang = mult[None, :] * np.pi * coords
    s, c = np.sin(ang), np.cos(ang)
    mapped = np.ones((n, d + 1))
    mapped[:, 1:] = np.cumprod(s, axis=1)
    mapped[:, :-1] *= c
    return mapped


def random_orthogonal(d: int, rng=None) -> np.ndarray:
    rng = np.random.default_rng() if rng is None else rng
    if d == 1:
        return np.array([[1.0 if rng.random() < 0.5 else -1.0]])
    return special_ortho_group.rvs(d, random_state=rng)


def scattered_hypersphere(n: int, d: int, rng=None, surface: bool = False,
                          min_magnitude: float = 0.0, seed: float = 0.5) -> np.ndarray:
    """Quasi-uniform scattered points on/in the unit d-hypersphere.

    R_d base sequence -> hyperspherical transform -> random rotation.
    Equivalent in function to the vendored ``ScatteredHypersphere``
    (reference utils.py:347-437).
    """
    rng = np.random.default_rng() if rng is None else rng
    if d == 1:
        pts = np.linspace(-1, 1, n + 2)[1:-1, None] if not surface else \
            np.sign(np.linspace(-1, 1, max(n, 2)))[:n, None]
        return pts if not surface else pts
    if surface:
        cube = Rd_sampling(n, d - 1, seed=seed)
        mapped = spherical_transform(cube)
    else:
        cube = Rd_sampling(n, d, seed=seed)
        mm = float(min_magnitude) ** d
        radius = (mm + cube[:, :1] * (1 - mm)) ** (1.0 / d)
        mapped = spherical_transform(cube[:, 1:]) * radius
    return mapped @ random_orthogonal(d, rng=rng)


def uniform_hypersphere(n: int, d: int, rng=None, surface: bool = False,
                        min_magnitude: float = 0.0) -> np.ndarray:
    """IID-uniform points on/in the unit d-hypersphere (Gaussian direction
    trick)."""
    rng = np.random.default_rng() if rng is None else rng
    if hasattr(rng, "standard_normal"):
        x = rng.standard_normal((n, d))
        u = rng.random(n)
    else:  # legacy RandomState
        x = rng.randn(n, d)
        u = rng.rand(n)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if surface:
        return x
    mm = float(min_magnitude) ** d
    r = (mm + u * (1 - mm)) ** (1.0 / d)
    return x * r[:, None]
