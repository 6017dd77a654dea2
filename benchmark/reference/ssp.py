"""Spatial semantic pointers on a hexagonal lattice, in NumPy.

The construction is the published one (Dumont and Eliasmith 2020; the
source's ``HexagonalSSPSpace``): the n + 1 unit vectors to the vertices of
a regular simplex in n dimensions, scaled by ``n_scales`` factors spaced
evenly over [1, pi], each set turned by ``n_rotates`` angles spaced evenly
over [0, 2 pi / 3), stacked as free phases and completed to a conjugate-
symmetric phase matrix A of ``2 m + 1`` rows.  A point x is encoded as
phi(x) = IFFT(exp(i A x / l)).real.

The VCO bank holds an SSP in the Fourier domain: oscillator j >= 1 holds
the real and imaginary parts of spectral row j, oscillator 0 the DC term.
"""

from __future__ import annotations

import numpy as np


def rotations(domain_dim: int, ssp_dim: int):
    """(n_rotates, n_scales) of a hexagonal space of ``ssp_dim`` rows: as
    many of each as ``ssp_dim = 2 r s (n + 1) + 1`` allows."""
    r = max(int(np.sqrt((ssp_dim - 1) / (2 * (domain_dim + 1)))), 1)
    return r, r


def phase_matrix(domain_dim: int, ssp_dim: int) -> np.ndarray:
    """The (ssp_dim, domain_dim) phase matrix of a 2-D hexagonal space."""
    if domain_dim != 2:
        raise ValueError("the reference builds 2-D hexagonal spaces only")
    n = domain_dim
    n_rot, n_sc = rotations(n, ssp_dim)
    c = n ** -1.5 * (np.sqrt(n + 1) + 1)
    simplex = np.vstack([np.sqrt(1 + 1 / n) * np.eye(n) - c,
                         np.full((1, n), n ** -0.5)])        # (n + 1, n)
    scaled = np.vstack([simplex * s
                        for s in np.linspace(1.0, np.pi, n_sc)])
    free = []
    for a in np.linspace(0, 2 * np.pi / 3, n_rot, endpoint=False):
        turn = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        free.append(scaled @ turn.T)
    free = np.vstack(free)                                   # (m, n)
    A = np.vstack([np.zeros((1, n)), free, -free[::-1]])
    if A.shape[0] != ssp_dim:
        raise ValueError(f"ssp_dim {ssp_dim} is not 2 r s (n + 1) + 1")
    return A


def encode(A: np.ndarray, length_scale: float, x) -> np.ndarray:
    """phi(x) for the rows of ``x`` (P, n): (P, d), float64."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    return np.fft.ifft(np.exp(1j * A @ (x / length_scale).T), axis=0).real.T


def to_fourier(d: int) -> np.ndarray:
    """(3k, d): an SSP to the oscillators' (Re, Im, 0) triples, spectral
    row j to oscillator j >= 1; the DC oscillator's rows are zero."""
    k = (d + 1) // 2
    j = np.arange(1, k)[:, None]
    theta = 2 * np.pi * j * np.arange(d)[None, :] / d
    M = np.zeros((3 * k, d))
    M[3::3] = np.cos(theta)
    M[4::3] = -np.sin(theta)
    return M


def from_fourier(d: int) -> np.ndarray:
    """(d, 3k): the oscillators' triples back to the SSP, the inverse DFT
    with the upper half of the spectrum taken by conjugate symmetry (for
    even d no oscillator holds the Nyquist row)."""
    k = (d + 1) // 2
    m = np.arange(d)[:, None]
    theta = 2 * np.pi * m * np.arange(1, k)[None, :] / d
    M = np.zeros((d, 3 * k))
    M[:, 0] = 1.0 / d
    M[:, 3::3] = 2 * np.cos(theta) / d
    M[:, 4::3] = -2 * np.sin(theta) / d
    return M
