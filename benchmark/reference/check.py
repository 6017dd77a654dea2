"""The comparisons that decide ``correct``: plain NumPy over what the
program made and what the reference computed again.  What the program
made is read only to be judged."""

from __future__ import annotations

import numpy as np
import torch


def host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def rel_gap(p, r) -> float:
    """||p - r|| over ||r|| (0 when both are 0 and p equals r)."""
    p, r = host(p), host(r)
    den = float(np.linalg.norm(r))
    num = float(np.linalg.norm(p - r))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def worst(gaps: dict):
    """The largest of named gaps and its name (a NaN counts as the
    largest)."""
    name = max(gaps, key=lambda k: (np.isnan(gaps[k]), gaps[k]))
    return gaps[name], name


def oscillator_gap(p, r) -> float:
    """SSP rows (T, d) compared oscillator by oscillator: each row's
    spectral rows 0 .. (d - 1) // 2, the values the VCO bank's
    oscillators hold, and over the rows the largest sum over oscillators
    of |F_p - F_r| (inf on a shape mismatch).

    A spike that falls in another step in one run than in the other moves
    one oscillator; a computation that has parted moves them all, and
    their gaps add here instead of averaging out across the SSP's
    entries."""
    p, r = host(p), host(r)
    if p.shape != r.shape or not p.size:
        return float("inf") if p.shape != r.shape else 0.0
    k = (p.shape[1] + 1) // 2
    diff = np.fft.fft(p - r, axis=1)[:, :k]
    return float(np.max(np.sum(np.abs(diff), axis=1)))
