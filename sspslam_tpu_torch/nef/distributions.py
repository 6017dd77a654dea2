"""Parameter distributions for ensemble construction (host-side, build-time).

A NumPy copy of :mod:`sspslam_tpu.nef.distributions`, so the same seed
draws the same parameters in both packages.  Covers the distributions the reference relies on from nengo:
Uniform, UniformHypersphere, ScatteredHypersphere (quasi-MC, used for the
OVC encoders at reference slam.py:205-207), Choice, and CosineSimilarity
(grid-cell intercepts, slam.py:278)."""

from __future__ import annotations

import numpy as np

from ..utils.sampling import scattered_hypersphere, uniform_hypersphere

__all__ = ["Distribution", "Uniform", "UniformHypersphere",
           "ScatteredHypersphere", "Choice", "CosineSimilarity", "Exponential",
           "Sobol", "Rd", "SSPSobol", "SSPMixedEval", "sample_dist"]


class Distribution:
    def sample(self, n, d=None, rng=None):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, integer=False):
        self.low, self.high, self.integer = low, high, integer

    def sample(self, n, d=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        shape = (n,) if d is None else (n, d)
        if self.integer:
            return rng.integers(self.low, self.high, size=shape)
        return rng.uniform(self.low, self.high, size=shape)


class UniformHypersphere(Distribution):
    def __init__(self, surface=False, min_magnitude=0.0):
        self.surface = surface
        self.min_magnitude = min_magnitude

    def sample(self, n, d=1, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return uniform_hypersphere(n, d, rng, surface=self.surface,
                                   min_magnitude=self.min_magnitude)


class ScatteredHypersphere(Distribution):
    def __init__(self, surface=False, min_magnitude=0.0):
        self.surface = surface
        self.min_magnitude = min_magnitude

    def sample(self, n, d=1, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return scattered_hypersphere(n, d, rng, surface=self.surface,
                                     min_magnitude=self.min_magnitude)


class Choice(Distribution):
    def __init__(self, options, weights=None):
        self.options = np.atleast_1d(np.asarray(options, dtype=np.float64))
        self.weights = weights

    def sample(self, n, d=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        opts = self.options
        if opts.ndim == 1 and d is not None and d > 1 and opts.shape[0] == d:
            # a single d-dim option replicated
            return np.tile(opts[None, :], (n, 1))
        p = None
        if self.weights is not None:
            w = np.asarray(self.weights, dtype=np.float64)
            p = w / w.sum()
        idx = rng.choice(len(opts), size=n, p=p)
        out = opts[idx]
        if d is not None and out.ndim == 1:
            out = np.tile(out[:, None], (1, d)) if d > 1 else out[:, None]
        return out


class CosineSimilarity(Distribution):
    """Distribution of the cosine similarity of random unit vectors in
    ``dimensions``-dimensional space: x = 2*Beta((D-1)/2, (D-1)/2) - 1."""

    def __init__(self, dimensions):
        self.dimensions = int(dimensions)

    def sample(self, n, d=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        a = (self.dimensions - 1) / 2.0
        x = 2.0 * rng.beta(a, a, size=(n,) if d is None else (n, d)) - 1.0
        return x


class Exponential(Distribution):
    def __init__(self, scale, shift=0.0, high=np.inf):
        self.scale, self.shift, self.high = scale, shift, high

    def sample(self, n, d=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        shape = (n,) if d is None else (n, d)
        x = self.shift + rng.exponential(self.scale, size=shape)
        return np.minimum(x, self.high)


class Sobol(Distribution):
    """Quasi-random Sobol points in [0, 1]^d (scipy.qmc backend)."""

    def sample(self, n, d=1, rng=None):
        from scipy.stats import qmc
        seed = None
        if rng is not None:
            seed = int(np.random.default_rng(
                rng.integers(2**31) if hasattr(rng, "integers")
                else rng.randint(2**31)).integers(2**31))
        return qmc.Sobol(d=d, seed=seed).random(n)


class Rd(Distribution):
    """Roberts' R_d low-discrepancy sequence in [0, 1]^d."""

    def sample(self, n, d=1, rng=None):
        from ..utils.sampling import Rd_sampling
        return Rd_sampling(n, d)


class SSPSobol(Distribution):
    """Evaluation points that are SSP encodings of quasi-random domain
    points (functional parity with reference sspspace.py:940-963, minus its
    broken nengolib import)."""

    def __init__(self, ssp_space):
        self.ssp_space = ssp_space

    def sample(self, n, d=1, rng=None):
        dd = self.ssp_space.domain_dim
        if dd == 1:
            pts = np.linspace(1.0 / n, 1, n)[:, None]
        else:
            pts = Sobol().sample(n, dd, rng=rng)
        if self.ssp_space.domain_bounds is not None:
            lo = self.ssp_space.domain_bounds[:, 0]
            hi = self.ssp_space.domain_bounds[:, 1]
            pts = lo + pts * (hi - lo)
        return np.asarray(self.ssp_space.encode(pts))


class SSPMixedEval(Distribution):
    """Half SSP-encoded quasi-random points (accuracy on the SSP manifold),
    half generic hypersphere samples (robustness off it) — parity with
    reference sspspace.py:966-992."""

    def __init__(self, ssp_space, dist=None):
        self.ssp_space = ssp_space
        self.dist = dist or ScatteredHypersphere(surface=False)

    def sample(self, n, d=1, rng=None):
        n_ssp = n // 2
        ssps = SSPSobol(self.ssp_space).sample(n_ssp, rng=rng)
        hypervecs = self.dist.sample(n - n_ssp, self.ssp_space.ssp_dim,
                                     rng=rng)
        return np.vstack([ssps, hypervecs])


def sample_dist(spec, n, d=None, rng=None):
    """Sample from a Distribution, or broadcast an array/scalar spec."""
    if isinstance(spec, Distribution):
        return spec.sample(n, d=d, rng=rng)
    arr = np.asarray(spec, dtype=np.float64)
    if arr.ndim == 0:
        shape = (n,) if d is None else (n, d)
        return np.full(shape, float(arr))
    if d is None:
        if arr.shape == (n,):
            return arr
        if arr.size == 1:
            return np.full((n,), float(arr))
        if arr.ndim == 1 and arr.shape[0] != n and len(arr) > 0:
            # a list like [intercept]*n or a single-value list
            if arr.shape[0] == 1:
                return np.full((n,), float(arr[0]))
    else:
        if arr.shape == (n, d):
            return arr
        if arr.ndim == 1 and arr.shape[0] == d:
            return np.tile(arr[None, :], (n, 1))
    raise ValueError(f"cannot broadcast spec of shape {arr.shape} to ({n}, {d})")
