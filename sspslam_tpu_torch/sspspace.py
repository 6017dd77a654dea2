"""Spatial Semantic Pointer (SSP) representation spaces.

Port of the parts of :mod:`sspslam_tpu.sspspace` that path integration
needs: ``SPSpace``, ``SSPSpace`` (encode, ``decode(method="from-set")``, the
domain sample banks), ``RandomSSPSpace``, ``HexagonalSSPSpace`` and
``RectangularSSPSpace`` with ``sample_grid_encoders``.  Phase matrices are built by the
same NumPy code from the same ``numpy.random.Generator`` stream, so a space
made from one seed is bitwise equal in both packages.

Host-facing methods take and return NumPy arrays, as in the JAX package;
the from-set decode runs its similarity matmul in float32 torch on the
``device`` it is given.  Not ported yet: ``direct-optim`` and the MLP
decoder.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammainc
from scipy.stats import qmc, special_ortho_group

from .ops.vsa import conjsym
from .utils.sampling import Rd_sampling, uniform_hypersphere

__all__ = ["SPSpace", "SSPSpace", "RandomSSPSpace", "HexagonalSSPSpace",
           "RectangularSSPSpace"]


class SPSpace:
    """Discrete symbol vocabulary of near-orthogonal unitary vectors, on the
    host in NumPy (as in the JAX package): ``domain_size`` unitary vectors
    (Gram-Schmidt orthogonalised), binding via circular convolution,
    inversion via the index involution."""

    def __init__(self, domain_size: int, dim: int, seed=None, vectors=None,
                 **kwargs):
        self.domain_size = int(domain_size)
        self.dim = int(dim)
        rng = (np.random.RandomState(seed) if seed is not None
               else np.random.RandomState())
        self.rng = rng

        if self.domain_size == 1:
            self.vectors = np.zeros((1, self.dim))
            self.vectors[:, 0] = 1
        elif vectors is not None:
            self.vectors = np.asarray(vectors, dtype=np.float64)
        else:
            v = uniform_hypersphere(self.domain_size, self.dim, rng,
                                    surface=True)
            v = self._np_make_unitary(v)
            # Gram-Schmidt style pass to reduce cross-talk between symbols
            for j in range(self.domain_size):
                q = v[j] / np.linalg.norm(v[j])
                for k in range(j + 1, self.domain_size):
                    v[k] = v[k] - (q @ v[k]) * q
            self.vectors = v
        self.inverse_vectors = self.invert(self.vectors)

    def encode(self, i):
        i = np.asarray(i).reshape(-1).astype(int)
        return self.vectors[i]

    @staticmethod
    def _np_make_unitary(v):
        fv = np.fft.fft(np.atleast_2d(v), axis=1)
        fv = fv / np.maximum(np.sqrt(fv.real**2 + fv.imag**2), 1e-12)
        return np.fft.ifft(fv, axis=1).real

    def decode(self, v, **kwargs):
        sims = self.vectors @ np.atleast_2d(v).T
        return np.argmax(sims, axis=0)

    def clean_up(self, v, **kwargs):
        return self.vectors[self.decode(v)]

    def normalize(self, v):
        return v / np.sqrt(np.sum(v**2))

    def make_unitary(self, v):
        return self._np_make_unitary(v)

    def identity(self):
        s = np.zeros(self.dim)
        s[0] = 1
        return s

    def bind(self, a, b):
        a = np.atleast_2d(a)
        b = np.atleast_2d(b)
        return np.fft.ifft(np.fft.fft(a, axis=1) * np.fft.fft(b, axis=1),
                           axis=1).real

    def invert(self, a):
        a = np.atleast_2d(a)
        return a[:, -np.arange(self.dim)]

    def get_binding_matrix(self, v):
        """Circulant matrix C(v) with C(v) @ w == bind(v, w)."""
        v = np.asarray(v).reshape(-1)
        i = np.arange(self.dim)
        return v[(i[:, None] - i[None, :]) % self.dim]


class SSPSpace:
    """Continuous fractional-power encoding phi(x) = IFFT(exp(i A x / l)).

    ``phase_matrix`` is (ssp_dim, domain_dim) and conjugate-symmetric.
    """

    def __init__(self, domain_dim: int, ssp_dim: int, phase_matrix,
                 domain_bounds=None, length_scale=1, rng=None, seed=None):
        self.domain_dim = int(domain_dim)
        self.ssp_dim = int(ssp_dim)
        self.length_scale = (np.asarray(length_scale, dtype=np.float64)
                             * np.ones((self.domain_dim, 1)))
        if rng is None:
            rng = np.random.default_rng(seed)
        self.rng = rng

        if domain_bounds is not None:
            domain_bounds = np.asarray(domain_bounds, dtype=np.float64)
            assert domain_bounds.shape[0] == domain_dim
        self.domain_bounds = domain_bounds

        phase_matrix = np.asarray(phase_matrix, dtype=np.float64)
        assert phase_matrix.shape == (ssp_dim, domain_dim)
        self.phase_matrix = phase_matrix
        self._sample_cache = {}

    @property
    def _ls_vec(self):
        return self.length_scale.flatten()

    def encode(self, x):
        """phi(x) = ifft(exp(i A x / l)) on the host in float64 (the
        tensor twin is :func:`sspslam_tpu_torch.ops.vsa.encode`)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        scaled = x / self._ls_vec[None, :]
        data = np.fft.ifft(np.exp(1j * self.phase_matrix @ scaled.T),
                           axis=0).real
        return data.T

    def decode(self, ssp, method="from-set", sampling_method="grid",
               num_samples=300, samples=None, *, device):
        """Decode SSPs back to domain points by argmax similarity over a
        sample bank (``from-set``), as a float32 matmul on ``device``
        (required: the caller names the device, as everywhere in the
        port)."""
        if method != "from-set":
            raise NotImplementedError(
                f"decode method {method!r} is not ported yet (from-set only)")
        ssp = np.atleast_2d(np.asarray(ssp, dtype=np.float64))
        if samples is None:
            sample_ssps, sample_points = self.get_sample_pts_and_ssps(
                method=sampling_method, num_points_per_dim=num_samples)
        else:
            sample_ssps, sample_points = samples
            assert sample_ssps.shape[1] == ssp.shape[1]
        norms = np.linalg.norm(ssp, axis=1, keepdims=True)
        unit_ssp = np.where(norms < 1e-6, ssp, ssp / np.maximum(norms, 1e-12))

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        pts = _decode_from_set(f32(sample_ssps), f32(sample_points),
                               f32(unit_ssp))
        return pts.cpu().numpy()

    # -- domain sampling ----------------------------------------------------
    def _domain_box(self):
        """Per-axis (lo, hi) sampling box; an unbounded space falls back to
        the reference's +-10 default box."""
        if self.domain_bounds is None:
            r = 10.0 * np.ones(self.domain_dim)
            return -r, r
        return self.domain_bounds[:, 0], self.domain_bounds[:, 1]

    def domain_grid(self, n_per_axis):
        """Regular mesh over the domain box: ``(axes, pts)`` with ``pts``
        flattened in ``np.meshgrid`` xy-order."""
        lo, hi = self._domain_box()
        counts = np.broadcast_to(np.asarray(n_per_axis, dtype=int),
                                 (self.domain_dim,))
        axes = [np.linspace(a, b, k) for a, b, k in zip(lo, hi, counts)]
        mesh = np.meshgrid(*axes)
        return axes, np.stack([m.ravel() for m in mesh], axis=-1)

    def get_sample_points(self, samples_per_dim=100, method="length-scale"):
        """Sample the domain box: a regular mesh (``grid``), a mesh at ~2
        points per kernel width (``length-scale``), or a low-discrepancy
        fill (``sobol`` / ``Rd``) of ``prod(samples_per_dim)`` points."""
        if method == "grid":
            return self.domain_grid(samples_per_dim)[1]
        if method == "length-scale":
            lo, hi = self._domain_box()
            widths = self.length_scale.ravel()[:self.domain_dim]
            counts = 2 * np.ceil((hi - lo) / widths).astype(int)
            return self.domain_grid(counts)[1]
        n_total = int(np.prod(samples_per_dim))
        if method == "sobol":
            u = qmc.Sobol(d=self.domain_dim, seed=self.rng).random(n_total)
        elif method == "Rd":
            u = Rd_sampling(n_total, self.domain_dim)
        else:
            raise NotImplementedError(
                f"Sampling method {method} is not implemented")
        lo, hi = self._domain_box()
        return lo + u * (hi - lo)

    def get_sample_pts_and_ssps(self, num_points_per_dim=100, method="grid"):
        key = (int(num_points_per_dim), method)
        if key in self._sample_cache:
            return self._sample_cache[key]
        pts = self.get_sample_points(method=method,
                                     samples_per_dim=num_points_per_dim)
        ssps = self.encode(pts)
        self._sample_cache[key] = (ssps, pts)
        return ssps, pts


def _decode_from_set(sample_ssps, sample_points, unit_ssp):
    sims = sample_ssps @ unit_ssp.T
    return sample_points[torch.argmax(sims, dim=0)]


class RandomSSPSpace(SSPSpace):
    """SSP space with random phase rows (uniform-in-ball or Gaussian)."""

    def __init__(self, domain_dim: int, ssp_dim: int, domain_bounds=None,
                 scale_min=0.25, scale_max=2.0, length_scale=1,
                 rng=None, seed=None, sampler="unif", norm_scale=None,
                 **kwargs):
        if rng is None:
            rng = np.random.default_rng(seed)
        n_samples = (ssp_dim - 1) // 2
        if sampler == "unif":
            samples = rng.normal(size=(n_samples, domain_dim))
            ssq = np.sum(samples**2, axis=1)
            fr = (scale_max
                  * gammainc(domain_dim / 2, ssq / 2) ** (1 / domain_dim)
                  / np.sqrt(ssq))
            phases = samples * fr[:, None]
        elif sampler == "norm":
            if norm_scale is None:
                norm_scale = np.sqrt(np.pi / 2) * (
                    (scale_max - scale_min) / 2 + scale_min)
            phases = rng.normal(loc=0.0, scale=norm_scale,
                                size=(n_samples, domain_dim))
        else:
            raise ValueError(f"unknown sampler {sampler!r}")
        phase_matrix = conjsym(phases)
        super().__init__(domain_dim, phase_matrix.shape[0], phase_matrix,
                         domain_bounds=domain_bounds,
                         length_scale=length_scale, rng=rng)


def _scales_for(scale_sampling, scale_min, scale_max, n_scales, rng):
    irrational_base = (1 + np.sqrt(5)) / 2
    if scale_sampling == "lin":
        if scale_min is None:
            scale_min = scale_max / (n_scales * (irrational_base - 1) + 1)
        return np.linspace(scale_min, scale_max, n_scales)
    elif scale_sampling == "log":
        if scale_min is None:
            scale_min = scale_max / (irrational_base ** (n_scales - 1))
        return np.geomspace(scale_min, scale_max, n_scales)
    elif scale_sampling == "rand":
        if scale_min is None:
            scale_min = 0
        return rng.uniform(scale_min, scale_max, n_scales)
    raise ValueError(f"unknown scale_sampling {scale_sampling!r}")


def _rotate_phases(phases_scaled, domain_dim, n_rotates, rng):
    if (n_rotates == 1) or (domain_dim == 1):
        return phases_scaled
    if domain_dim == 2:
        angles = np.linspace(0, 2 * np.pi / 3, n_rotates, endpoint=False)
        R = np.stack([np.stack([np.cos(angles), -np.sin(angles)], axis=1),
                      np.stack([np.sin(angles), np.cos(angles)], axis=1)],
                     axis=1)
    else:
        R = special_ortho_group.rvs(domain_dim, size=n_rotates,
                                    random_state=rng)
        if n_rotates == 1:
            R = R[None]
    return (R @ phases_scaled.T).transpose(0, 2, 1).reshape(-1, domain_dim)


class _GridSSPSpace(SSPSpace):
    """Shared machinery for grid (hexagonal) SSP spaces."""

    _basis_extra = 1  # hexagonal: simplex has domain_dim+1 vertices

    def __init__(self, domain_dim, ssp_dim, n_rotates, n_scales,
                 scale_min, scale_max, scale_sampling,
                 domain_bounds, length_scale, rng, seed, default_dim):
        if rng is None:
            rng = np.random.default_rng(seed)
        basis_dim = domain_dim + self._basis_extra
        # a requested total dim (not rot/scale counts) solves for the counts
        if (n_rotates == 5) and (n_scales == 5) and (ssp_dim != default_dim):
            n_rotates = int(np.sqrt((ssp_dim - 1) / (2 * basis_dim)))
            n_rotates = max(n_rotates, 1)
            n_scales = n_rotates

        phases_basis = self._make_basis(domain_dim)

        self.grid_basis_dim = basis_dim
        self.num_grids = n_rotates * n_scales
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.n_scales = n_scales
        self.n_rotates = n_rotates

        if domain_dim == 1:
            n_scales = n_scales * n_rotates
        scales = _scales_for(scale_sampling, scale_min, scale_max, n_scales,
                             rng)
        phases_scaled = np.vstack([phases_basis * s for s in scales])
        phases_rot = _rotate_phases(phases_scaled, domain_dim, n_rotates, rng)
        phase_matrix = conjsym(phases_rot)
        super().__init__(domain_dim, phase_matrix.shape[0], phase_matrix,
                         domain_bounds=domain_bounds,
                         length_scale=length_scale, rng=rng)

    def _make_basis(self, domain_dim):
        raise NotImplementedError

    def _grid_encoder_pattern_size(self):
        """Number of Fourier rows per grid module."""
        raise NotImplementedError

    def sample_grid_encoders(self, n_neurons, method="sobol"):
        """Per-neuron single-grid-module encoders: a Fourier impulse confined
        to one module's rows, conjugate-symmetric completed."""
        d, A = self.ssp_dim, self.phase_matrix
        sub = self._grid_encoder_pattern_size()
        k = (d - 1) // 2
        N = ((d - 2) // 2 if d % 2 == 0 else (d - 1) // 2) // sub

        num_pts = (int(np.ceil(n_neurons ** (1 / self.domain_dim)))
                   if method == "grid" else n_neurons)
        pts = self.get_sample_points(num_pts, method=method)[:n_neurons]
        n_per = int(np.floor(n_neurons / N))
        sorts = np.concatenate([
            np.repeat(np.arange(N), n_per),
            self.rng.integers(0, N, size=n_neurons - N * n_per)])

        encoders = np.zeros((n_neurons, d))
        for i in range(n_neurons):
            res = np.zeros(d, dtype=complex)
            lo = 1 + sorts[i] * sub
            hi = lo + sub
            res[lo:hi] = np.exp(1j * A[lo:hi] @ pts[i])
            res[k + 1:] = np.conjugate(np.flip(res[1:k + 1]))
            res[0] = 1
            if d % 2 == 0:
                res[d // 2] = 1
            encoders[i] = np.fft.ifft(res).real
        encoders /= np.linalg.norm(encoders, axis=-1, keepdims=True)
        return encoders


class HexagonalSSPSpace(_GridSSPSpace):
    """Simplex-vertex (hexagonal-lattice) SSP space.
    ``ssp_dim = 2 * n_rotates * n_scales * (domain_dim+1) + 1``."""

    _basis_extra = 1

    def __init__(self, domain_dim: int, ssp_dim: int = 151, n_rotates: int = 5,
                 n_scales: int = 5, scale_min=1, scale_max=np.pi,
                 scale_sampling="lin", domain_bounds=None, length_scale=1,
                 rng=None, seed=None):
        super().__init__(domain_dim, ssp_dim, n_rotates, n_scales, scale_min,
                         scale_max, scale_sampling, domain_bounds,
                         length_scale, rng, seed, default_dim=151)

    def _make_basis(self, domain_dim):
        # (domain_dim+1) unit vectors to the vertices of a regular simplex
        return np.hstack([
            np.sqrt(1 + 1 / domain_dim) * np.identity(domain_dim)
            - (domain_dim ** (-3 / 2)) * (np.sqrt(domain_dim + 1) + 1),
            (domain_dim ** (-1 / 2)) * np.ones((domain_dim, 1)),
        ]).T

    def _grid_encoder_pattern_size(self):
        return self.domain_dim + 1


class RectangularSSPSpace(_GridSSPSpace):
    """Axis-aligned basis SSP space.
    ``ssp_dim = 2 * n_rotates * n_scales * domain_dim + 1``."""

    _basis_extra = 0

    def __init__(self, domain_dim: int, ssp_dim: int = 101,
                 n_rotates: int = 5, n_scales: int = 5, scale_min=None,
                 scale_max=np.pi, scale_sampling="lin", domain_bounds=None,
                 length_scale=1, rng=None, seed=None):
        super().__init__(domain_dim, ssp_dim, n_rotates, n_scales, scale_min,
                         scale_max, scale_sampling, domain_bounds,
                         length_scale, rng, seed, default_dim=101)

    def _make_basis(self, domain_dim):
        return np.eye(domain_dim)

    def _grid_encoder_pattern_size(self):
        return self.domain_dim
