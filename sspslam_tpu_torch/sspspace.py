"""Spatial Semantic Pointer (SSP) representation spaces.

Port of :mod:`sspslam_tpu.sspspace`: ``SPSpace``, ``SSPSpace`` (encode
and its Fourier form and Jacobian, the length scale and its fit, the four
decode methods, the domain sample banks, the host algebra, the encoder
samplers, the similarity field, the MLP decoder's training and the
reference Keras decoder's loading), ``RandomSSPSpace``,
``HexagonalSSPSpace`` and ``RectangularSSPSpace``.  Phase matrices are
built by the same NumPy code from the same ``numpy.random.Generator``
stream, so a space made from one seed is bitwise equal in both packages.

Host-facing methods take and return NumPy arrays, as in the JAX package;
what runs on tensors (the decodes, the Newton polish, the decoder's
training) runs in float32 on the ``device`` the caller names.  The MLP
decoder's parameters (``decoder_params``) are six float32 NumPy arrays,
saved to and loaded from the JAX package's npz file (keys ``p0``-``p5``),
so a decoder trained by either package loads in the other.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from scipy.optimize import minimize
from scipy.special import gammainc
from scipy.stats import qmc, special_ortho_group

from .ops import vsa
from .ops.vsa import conjsym
from .utils.sampling import Rd_sampling, uniform_hypersphere

__all__ = ["SPSpace", "SSPSpace", "RandomSSPSpace", "HexagonalSSPSpace",
           "RectangularSSPSpace", "conjsym"]

_constructaxisfromphases = vsa.construct_axes_from_phases
_get_sub_FourierSSP = vsa.sub_fourier_extract
_get_sub_SSP = vsa.sub_ssp_extract
_proj_sub_FourierSSP = vsa.sub_fourier_project
_proj_sub_SSP = vsa.sub_ssp_project


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device raises when there is
    no card (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


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
        self.decoder_params = None  # the MLP decoder: six float32 arrays

        phase_matrix = np.asarray(phase_matrix, dtype=np.float64)
        assert phase_matrix.shape == (ssp_dim, domain_dim)
        self.phase_matrix = phase_matrix
        self._sample_cache = {}

    # -- length scale -------------------------------------------------------
    def update_lengthscale(self, scale):
        scale = np.asarray(scale, dtype=np.float64)
        if scale.size == 1:
            self.length_scale = float(scale) * np.ones((self.domain_dim, 1))
        else:
            assert scale.size == self.domain_dim
            self.length_scale = scale.reshape(self.domain_dim, 1)
        self._sample_cache.clear()

    def optimize_lengthscale(self, init_xs, init_ys):
        """Fit the length scale by the least-squares error of regressing
        ``init_ys`` on the encoded ``init_xs`` (scipy L-BFGS-B); a failed
        fit keeps the old scale."""
        ls_0 = self.length_scale.flatten()
        saved = self.length_scale
        self.length_scale = np.ones((self.domain_dim, 1))

        def min_func(length_scale):
            init_phis = self.encode(init_xs / length_scale)
            W = np.linalg.pinv(init_phis.T) @ init_ys
            mu = np.dot(init_phis.T, W)
            diff = init_ys - mu.T
            return np.sum(diff**2)

        ret = minimize(min_func, x0=ls_0, method="L-BFGS-B",
                       bounds=self.domain_dim * [(1e-8, 1e5)])
        self.length_scale = ret.x.reshape(-1, 1)
        if not ret.success:
            self.length_scale = saved
        self._sample_cache.clear()

    # -- encoding -----------------------------------------------------------
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

    def encode_fourier(self, x):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        scaled = x / self._ls_vec[None, :]
        return np.exp(1j * self.phase_matrix @ scaled.T).T

    def encode_and_deriv(self, x):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        ls_inv = np.diag(1.0 / self._ls_vec)
        scaled = x @ ls_inv
        fssp = np.exp(1j * self.phase_matrix @ scaled.T)       # (d, P)
        phi = np.fft.ifft(fssp, axis=0).real.T
        A_ls = self.phase_matrix @ ls_inv                       # (d, n)
        dfssp = 1j * A_ls[:, None, :] * fssp[:, :, None]        # (d, P, n)
        dphi = np.fft.ifft(dfssp, axis=0).real.transpose(1, 0, 2)
        return phi, dphi

    # -- decoding -----------------------------------------------------------
    def _newton_tables(self):
        """``phase_matrix / length_scale`` and the (lo, hi) bounds (None
        when the space is unbounded), for the Newton polish."""
        mat = self.phase_matrix @ np.diag(1 / self._ls_vec)
        lo = hi = None
        if self.domain_bounds is not None:
            lo, hi = self.domain_bounds[:, 0], self.domain_bounds[:, 1]
        return mat, lo, hi

    def decode(self, ssp, method="from-set", sampling_method="grid",
               num_samples=300, samples=None, *, device, **kwargs):
        """Decode SSPs back to domain points, in float32 on ``device``
        (required: the caller names the device, as everywhere in the
        port).

        ``from-set``: argmax similarity over a sample bank.
        ``direct-optim``: from-set start, then ``iters`` (default 20)
        damped-Newton steps on the Fourier-domain similarity
        (:func:`_newton_refine`).  ``network``: the trained MLP decoder
        (:meth:`train_decoder_net`).  ``network-optim``: the MLP's output
        as the start, then 20 Newton steps.  Any other method raises
        ``NotImplementedError``.
        """
        device = _device(device)
        ssp = np.atleast_2d(np.asarray(ssp, dtype=np.float64))
        if method in ("from-set", "direct-optim"):
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

        if method in ("network", "network-optim") \
                and self.decoder_params is None:
            raise RuntimeError("Network not trained for decoding. "
                               "Call train_decoder_net first.")
        if method == "from-set":
            return _decode_from_set(f32(sample_ssps), f32(sample_points),
                                    f32(unit_ssp)).cpu().numpy()
        if method == "direct-optim":
            x0 = _decode_from_set(f32(sample_ssps), f32(sample_points),
                                  f32(unit_ssp))
            iters = kwargs.get("iters", 20)
        elif method == "network":
            params = [f32(p) for p in self.decoder_params]
            return _mlp_apply(params, f32(ssp)).cpu().numpy()
        elif method == "network-optim":
            x0 = _mlp_apply([f32(p) for p in self.decoder_params], f32(ssp))
            iters = 20
        else:
            raise NotImplementedError(f"Unrecognized decoding method: {method}")
        mat, lo, hi = self._newton_tables()
        return _newton_refine(mat, unit_ssp, x0, lo, hi, iters=iters,
                              device=device)

    def clean_up(self, ssp, method="from-set", sampling_method="grid",
                 num_samples=300, *, device):
        x = self.decode(ssp, method, sampling_method, num_samples,
                        device=device)
        return self.encode(x)

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

    def get_sample_ssps(self, num_points, **kwargs):
        return self.encode(self.get_sample_points(num_points, **kwargs))

    # -- algebra (host NumPy) -----------------------------------------------
    def normalize(self, ssp):
        return ssp / np.maximum(np.sqrt(np.sum(np.asarray(ssp)**2)), 1e-8)

    def make_unitary(self, ssp):
        ssp = np.asarray(ssp)
        fssp = np.fft.fft(ssp, axis=-1)
        fssp = fssp / np.maximum(np.abs(fssp), 1e-8)
        return np.fft.ifft(fssp, axis=-1).real

    def make_unitary_fourier(self, fssp):
        return fssp / np.maximum(np.abs(fssp), 1e-8)

    def identity(self):
        s = np.zeros(self.ssp_dim)
        s[0] = 1
        return s

    def bind(self, a, b):
        a = np.atleast_2d(a)
        b = np.atleast_2d(b)
        return np.fft.ifft(np.fft.fft(a, axis=1) * np.fft.fft(b, axis=1),
                           axis=1).real

    def invert(self, a):
        a = np.atleast_2d(a)
        return a[:, -np.arange(self.ssp_dim)]

    # -- encoder sampling for neural populations ----------------------------
    def sample_wave_encoders(self, n_neurons, method="sobol"):
        """Single-frequency Fourier impulse encoders."""
        d, A = self.ssp_dim, self.phase_matrix
        N = (d - 2) // 2
        num_pts = (int(np.ceil(n_neurons ** (1 / self.domain_dim)))
                   if method == "grid" else n_neurons)
        pts = self.get_sample_points(num_pts, method=method)[:n_neurons]
        if n_neurons == N:
            sorts = np.arange(N)
        elif n_neurons > N:
            sorts = np.concatenate([np.arange(N),
                                    self.rng.integers(0, N,
                                                      size=n_neurons - N)])
        else:
            sorts = self.rng.integers(0, N, size=n_neurons)
        encoders = np.zeros((n_neurons, d))
        for i in range(n_neurons):
            res = np.zeros(d, dtype=complex)
            j = sorts[i] + 1
            res[j] = np.exp(1j * A[j] @ pts[i])
            res[-j] = np.exp(1j * A[-j] @ pts[i])
            encoders[i] = np.fft.ifft(res).real
        return encoders

    def similarity_grid(self, ssp, n_grid=100):
        """Similarity field <ssp, phi(grid)> over the domain box:
        ``(axes, field)``, the field shaped onto the mesh (1-D: ``(n,)``;
        2-D: ``(ny, nx)`` as ``np.meshgrid``)."""
        axes, pts = self.domain_grid(n_grid)
        field = self.encode(pts) @ np.ravel(np.asarray(ssp))
        if self.domain_dim == 1:
            return axes, field
        return axes, field.reshape(tuple(len(a) for a in reversed(axes)))

    def similarity_plot(self, ssp, n_grid=100, plot_type="heatmap", ax=None,
                        **kwargs):
        """Render the similarity field of ``ssp`` (1-D: a line; 2-D: a
        ``heatmap``/``contour``/``contourf``) with matplotlib."""
        import matplotlib.pyplot as plt
        if self.domain_dim > 2:
            raise NotImplementedError(
                "similarity_plot supports 1-D and 2-D domains")
        ax = ax if ax is not None else plt.figure().add_subplot(111)
        axes, field = self.similarity_grid(ssp, n_grid=n_grid)
        if self.domain_dim == 1:
            im = ax.plot(axes[0], field, **kwargs)
        else:
            draw = {"heatmap": ax.pcolormesh, "contour": ax.contour,
                    "contourf": ax.contourf}[plot_type]
            im = draw(axes[0], axes[1], field, **kwargs)
            ax.set_ylim(axes[1][0], axes[1][-1])
        ax.set_xlim(axes[0][0], axes[0][-1])
        return im

    # -- MLP decoder ----------------------------------------------------------
    def _decoder_file(self, folder="decode_params"):
        """The npz file :meth:`train_decoder_net` writes and reads, named as
        the JAX package names it."""
        return os.path.join(
            folder,
            f"{type(self).__name__}_domaindim{self.domain_dim}"
            f"_lenscale{float(self.length_scale[0, 0])}"
            f"_sspdim{self.ssp_dim}.npz")

    def train_decoder_net(self, n_training_pts=200000, n_hidden_units=8,
                          learning_rate=1e-3, n_epochs=20, load_file=True,
                          save_file=True, folder="decode_params",
                          batch_size=2048, verbose=False, *, device="cuda"):
        """Train the MLP decoder ssp -> x (Dense(d, relu) -> Dense(h,
        relu) -> Dense(n)) on ``n_training_pts`` Rd points with Adam (lr
        ``learning_rate``, betas (0.9, 0.999), eps 1e-8: optax's ``adam``
        rule), in float32 on ``device``.  The initial weights and the
        epochs' permutations are the JAX package's (``default_rng(0)``
        draws).  Reads a saved decoder from ``folder`` if there is one and
        ``load_file`` (returns None), else returns the per-epoch mean
        losses and, with ``save_file``, writes the npz."""
        os.makedirs(folder, exist_ok=True)
        path_name = self._decoder_file(folder)
        if load_file and os.path.exists(path_name):
            try:
                with np.load(path_name) as f:
                    self.decoder_params = [np.asarray(f[k], np.float32)
                                           for k in sorted(f.files)]
                return None
            except Exception as e:  # pragma: no cover
                warnings.warn(f"Error loading decoder: {e}")

        device = _device(device)
        ssps, pts = self.get_sample_pts_and_ssps(
            num_points_per_dim=n_training_pts, method="Rd")
        ssps = torch.as_tensor(np.asarray(ssps, np.float32), device=device)
        pts = torch.as_tensor(np.asarray(pts, np.float32), device=device)
        nprng = np.random.default_rng(0)
        d, h, n = self.ssp_dim, n_hidden_units, self.domain_dim
        params = [torch.tensor(np.asarray(a, np.float32), device=device,
                               requires_grad=True) for a in (
            nprng.normal(size=(d, d)) * np.sqrt(2.0 / d), np.zeros(d),
            nprng.normal(size=(d, h)) * np.sqrt(2.0 / d), np.zeros(h),
            nprng.normal(size=(h, n)) * np.sqrt(2.0 / h), np.zeros(n))]
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)

        n_pts = ssps.shape[0]
        steps_per_epoch = max(1, n_pts // batch_size)
        rng = np.random.default_rng(0)
        history = []
        for epoch in range(n_epochs):
            perm = torch.as_tensor(rng.permutation(n_pts), device=device)
            ep_loss = torch.zeros((), dtype=torch.float64, device=device)
            for i in range(steps_per_epoch):
                idx = perm[i * batch_size:(i + 1) * batch_size]
                loss = torch.mean((_mlp_apply(params, ssps[idx])
                                   - pts[idx]) ** 2)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                ep_loss += loss.detach()
            history.append(float(ep_loss) / steps_per_epoch)
            if verbose:
                print(f"decoder-net epoch {epoch}: loss {history[-1]:.5f}")

        self.decoder_params = [p.detach().cpu().numpy() for p in params]
        if save_file:
            np.savez(path_name, **{f"p{i}": p for i, p in
                                   enumerate(self.decoder_params)})
        return history

    def load_keras_decoder_net(self, path):
        """Load a decoder MLP trained by the reference implementation (a
        Keras ``.h5``: Dense(ssp_dim, relu) -> Dense(h, relu) ->
        Dense(domain_dim)) into ``decoder_params``."""
        import h5py

        kernels, biases = [], []
        with h5py.File(path, "r") as f:
            root = f["model_weights"] if "model_weights" in f else f
            names = root.attrs.get("layer_names")
            layer_names = ([n.decode() if isinstance(n, bytes) else str(n)
                            for n in names] if names is not None
                           else list(root.keys()))

            def collect(g):
                ks, bs = [], []

                def visit(_, obj):
                    if isinstance(obj, h5py.Dataset):
                        if "kernel" in obj.name.rsplit("/", 1)[-1]:
                            ks.append(np.asarray(obj))
                        elif "bias" in obj.name.rsplit("/", 1)[-1]:
                            bs.append(np.asarray(obj))
                g.visititems(visit)
                return ks, bs

            for name in layer_names:
                if name not in root:
                    continue
                ks, bs = collect(root[name])
                kernels.extend(ks)
                biases.extend(bs)
        if len(kernels) != 3 or len(biases) != 3:
            raise ValueError(
                f"{path}: expected 3 Dense layers (got {len(kernels)} "
                f"kernels, {len(biases)} biases) — not a reference "
                "decoder net")
        if kernels[0].shape[0] != self.ssp_dim or \
                kernels[2].shape[1] != self.domain_dim:
            raise ValueError(
                f"{path}: net maps {kernels[0].shape[0]} -> "
                f"{kernels[2].shape[1]}, space is {self.ssp_dim} -> "
                f"{self.domain_dim}")
        self.decoder_params = [np.asarray(a, np.float32) for pair in
                               zip(kernels, biases) for a in pair]
        return self.decoder_params


def _decode_from_set(sample_ssps, sample_points, unit_ssp):
    sims = sample_ssps @ unit_ssp.T
    return sample_points[torch.argmax(sims, dim=0)]


def _mlp_apply(params, x):
    """The decoder MLP on tensors: relu(x W1 + b1) -> relu(. W2 + b2) ->
    . W3 + b3."""
    w1, b1, w2, b2, w3, b3 = params
    h = torch.relu(x @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    return h @ w3 + b3


def _solve_small(A, b):
    """x with A x = b for a batch of n x n systems (..., n, n), (..., n):
    for n <= 3 by the adjugate in elementwise ops (no LAPACK call and no
    host read, so a CUDA graph can capture it), else by
    ``torch.linalg.solve_ex`` without its error check."""
    n = A.shape[-1]
    if n == 1:
        return b / A[..., 0]
    if n == 2:
        # LU with partial pivoting, as LAPACK's getrf / getrs order it
        swap = A[..., 1, 0].abs() > A[..., 0, 0].abs()
        r0 = torch.where(swap[..., None], A[..., 1, :], A[..., 0, :])
        r1 = torch.where(swap[..., None], A[..., 0, :], A[..., 1, :])
        b0 = torch.where(swap, b[..., 1], b[..., 0])
        b1 = torch.where(swap, b[..., 0], b[..., 1])
        lo = r1[..., 0] / r0[..., 0]
        x1 = (b1 - lo * b0) / (r1[..., 1] - lo * r0[..., 1])
        x0 = (b0 - r0[..., 1] * x1) / r0[..., 0]
        return torch.stack([x0, x1], dim=-1)
    if n == 3:
        r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
        # the columns of adj(A) = det(A) A^-1 are the cross products of
        # A's rows: [r1 x r2, r2 x r0, r0 x r1]
        c0 = torch.linalg.cross(r1, r2, dim=-1)
        c1 = torch.linalg.cross(r2, r0, dim=-1)
        c2 = torch.linalg.cross(r0, r1, dim=-1)
        det = torch.sum(r0 * c0, dim=-1)
        adj = torch.stack([c0, c1, c2], dim=-1)
        return torch.einsum("...ij,...j->...i", adj, b) / det[..., None]
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _newton_refine_core(mat, t_re, t_im, x0, lo_hi, iters):
    """Damped-Newton maximisation of Re<exp(i M x), conj(F(target))> for
    every row of a batch (leading axes of ``x0`` (..., n) and of ``t_re``
    / ``t_im`` (..., d)), in float32 tensor ops with no host read, so the
    SLAM clean-up runs it inside a captured step.

    ``mat`` (d, n) is phase_matrix / length_scale; (t_re, t_im) is
    conj(FFT(target)); ``lo_hi`` an optional (lo, hi) pair of (n,)
    tensors.  Each of the ``iters`` steps takes the Newton step and three
    fractions of it and three gradient steps, clips them into the bounds
    and keeps the best of those and the current point (the first best, as
    ``jnp.argmin``), as the JAX package's ``_newton_refine_core`` does."""
    n = x0.shape[-1]
    # made by a kernel, not uploaded: the step may be under capture
    ridge = 1e-6 * torch.eye(n, dtype=x0.dtype, device=x0.device)
    t_re_c, t_im_c = t_re[..., None, :], t_im[..., None, :]
    x = x0
    for _ in range(iters):
        ph = x @ mat.T
        fr, fi = torch.cos(ph), torch.sin(ph)
        zr = fr * t_re - fi * t_im
        zi = fr * t_im + fi * t_re
        g = zi @ mat
        H = mat.T @ (zr[..., :, None] * mat)
        dx = _solve_small(H + ridge, -g)
        gnorm = g / torch.clamp_min(torch.linalg.vector_norm(
            g, dim=-1, keepdim=True), 1e-12)
        cands = torch.stack([
            x, x + dx, x + 0.5 * dx, x + 0.1 * dx,
            x - 0.1 * gnorm, x - 0.02 * gnorm, x - 0.004 * gnorm],
            dim=-2)                                          # (..., 7, n)
        if lo_hi is not None:
            cands = torch.clamp(cands, lo_hi[0], lo_hi[1])
        ph = cands @ mat.T                                   # (..., 7, d)
        fvals = -torch.sum(torch.cos(ph) * t_re_c - torch.sin(ph) * t_im_c,
                           dim=-1)
        best = torch.argmin(fvals, dim=-1)
        x = torch.gather(cands, -2, best[..., None, None].expand(
            best.shape + (1, n))).squeeze(-2)
    return x


def _newton_refine(mat, unit_fssp_targets, x0, lo, hi, iters=20, *, device):
    """Batched damped-Newton maximisation of Re<exp(i M x),
    conj(F(target))> from the start points ``x0``, on ``device`` in
    float32; returns the refined points as a NumPy array.

    The conjugated objective peaks at +x, as in the JAX package (the
    reference's unconjugated form peaks at -x)."""
    device = torch.device(device)
    tgt = np.conj(np.fft.fft(np.asarray(unit_fssp_targets), axis=-1))

    def f32(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, dtype=torch.float32, device=device)
    lo_hi = None if lo is None else (f32(lo), f32(hi))
    x = _newton_refine_core(f32(mat), f32(tgt.real), f32(tgt.imag), f32(x0),
                            lo_hi, iters)
    return x.cpu().numpy()


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
                 rng=None, seed=None, **kwargs):
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
                 length_scale=1, rng=None, seed=None, **kwargs):
        super().__init__(domain_dim, ssp_dim, n_rotates, n_scales, scale_min,
                         scale_max, scale_sampling, domain_bounds,
                         length_scale, rng, seed, default_dim=101)

    def _make_basis(self, domain_dim):
        return np.eye(domain_dim)

    def _grid_encoder_pattern_size(self):
        return self.domain_dim
