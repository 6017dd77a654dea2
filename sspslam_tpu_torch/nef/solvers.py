"""Decoder solving: regularised least squares over sampled evaluation points.

Port of :mod:`sspslam_tpu.nef.solvers`.  Small solves run on the host in
NumPy (the same code, so both packages solve bitwise-equal decoders); large
ones run in float32 torch on the ``device`` they are given: currents, rate
curves, the normal equations and the Cholesky solve, with the decoders left
on that device.  The thresholds between the two are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lstsq_l2", "lstsq_l2_batched", "solve_decoders_on_device",
           "solve_decoders_batched_on_device"]

#: ensembles with at least this many neurons solve on the device
DEVICE_SOLVE_MIN_NEURONS = 2048

#: batched (EnsembleArray) solves move to the device when the rate
#: tabulation k*P*n exceeds this (the VCO bank at ssp_dim 97 / 800 neurons
#: is 49 * 1600 * 800 = 62.7 M)
DEVICE_SOLVE_MIN_BATCH_ELEMS = 5_000_000


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _cholesky_solve(G, B):
    L = torch.linalg.cholesky(G)
    z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)


def solve_decoders_on_device(neuron_type, scaled_encoders, bias, eval_points,
                             targets, reg: float = 0.1, *, device):
    """Full decoder solve for a LARGE single ensemble in float32 on
    ``device``: scaled_encoders (n, dim), bias (n,), eval_points (P, dim),
    targets (P, d)  ->  (n, d) tensor on ``device``."""
    E = _f32(scaled_encoders, device)
    b = _f32(bias, device)
    A = neuron_type.rates(_f32(eval_points, device) @ E.T + b[None, :])
    m, n = A.shape
    sigma = reg * torch.max(A)
    G = A.T @ A + m * sigma**2 * torch.eye(n, dtype=A.dtype, device=device)
    return _cholesky_solve(G, A.T @ _f32(targets, device))


def solve_decoders_batched_on_device(neuron_type, scaled_encoders, bias,
                                     eval_points, targets,
                                     reg: float = 0.1, *, device):
    """Batched (EnsembleArray) decoder solve in float32 on ``device``, with
    a per-element sigma as in :func:`lstsq_l2_batched`.

    scaled_encoders (k, n, dim), bias (k, n), eval_points (P, dim) or
    (k, P, dim), targets (P, d) or (k, P, d)  ->  (k, n, d) tensor on
    ``device``
    """
    E = _f32(scaled_encoders, device)
    b = _f32(bias, device)
    ep = _f32(eval_points, device)
    k = E.shape[0]
    Y = _f32(targets, device)
    if Y.ndim == 2:
        Y = Y.expand((k,) + tuple(Y.shape))
    J = (torch.einsum("kpd,knd->kpn", ep, E) if ep.ndim == 3
         else torch.einsum("pd,knd->kpn", ep, E)) + b[:, None, :]
    A = neuron_type.rates(J)                                   # (k, P, n)
    m, n = A.shape[1], A.shape[2]
    sigma = reg * torch.amax(A, dim=(1, 2))                    # (k,)
    G = torch.einsum("kpn,kpm->knm", A, A) + (
        m * sigma[:, None, None] ** 2
        * torch.eye(n, dtype=A.dtype, device=device)[None])
    return _cholesky_solve(G, torch.einsum("kpn,kpd->knd", A, Y))


def lstsq_l2(activities: np.ndarray, targets: np.ndarray, reg: float = 0.1):
    """Solve decoders D minimising ||A D - Y||^2 + m sigma^2 ||D||^2,
    sigma = reg * max(A).

    activities : (m, n); targets : (m, d)  ->  D : (n, d)
    """
    A = np.asarray(activities, dtype=np.float32)
    Y = np.asarray(targets, dtype=np.float32)
    m, n = A.shape
    sigma = reg * A.max() if A.size else reg
    G = A.T @ A + (m * sigma**2 * np.eye(n)).astype(np.float32)
    B = A.T @ Y
    return np.linalg.solve(G, B)


def lstsq_l2_batched(activities: np.ndarray, targets: np.ndarray,
                     reg: float = 0.1):
    """Batched solve: activities (k, m, n), targets (k, m, d) or (m, d)
    shared  ->  (k, n, d)."""
    A = np.asarray(activities, dtype=np.float32)
    Y = np.asarray(targets, dtype=np.float32)
    k, m, n = A.shape
    if Y.ndim == 2:
        Y = np.broadcast_to(Y, (k,) + Y.shape)
    sigma = reg * A.max(axis=(1, 2), keepdims=True)
    At = np.ascontiguousarray(A.transpose(0, 2, 1))
    G = At @ A + (m * sigma**2 * np.eye(n)[None, :, :]).astype(np.float32)
    B = At @ Y
    return np.linalg.solve(G, B)
