"""Spike-raster preprocessing for visualisation (a copy of
:mod:`sspslam_tpu.utils.spikes`; NumPy on the host).

Small NumPy equivalents of the nengo_extras.plot_spikes helpers the GIF
scripts use: cluster (sort neurons by activity similarity), merge (pool
neighbouring rows), and sample_by_variance (keep the most variable
neurons).  ``plot_spikes`` imports matplotlib when called."""

from __future__ import annotations

import numpy as np

__all__ = ["cluster", "merge", "sample_by_variance", "plot_spikes"]


def cluster(t, spikes, filter_width=0.002, dt=None):
    """Sort neurons so that similarly-active ones are adjacent (greedy
    nearest-neighbour ordering on lowpass-filtered trains)."""
    t = np.asarray(t)
    spikes = np.asarray(spikes)
    dt = dt or (t[1] - t[0] if len(t) > 1 else 0.001)
    a = float(np.exp(-dt / max(filter_width, dt)))
    filt = np.zeros_like(spikes, dtype=np.float64)
    acc = np.zeros(spikes.shape[1])
    for i in range(spikes.shape[0]):
        acc = a * acc + (1 - a) * spikes[i]
        filt[i] = acc
    # greedy ordering by correlation
    X = filt.T
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    Xn = X / np.maximum(norms, 1e-12)
    n = X.shape[0]
    remaining = list(range(n))
    order = [remaining.pop(0)]
    while remaining:
        last = Xn[order[-1]]
        sims = Xn[remaining] @ last
        j = int(np.argmax(sims))
        order.append(remaining.pop(j))
    return t, spikes[:, order]


def merge(t, spikes, num: int):
    """Pool neuron rows down to ``num`` traces by averaging groups."""
    spikes = np.asarray(spikes)
    n = spikes.shape[1]
    num = min(num, n)
    edges = np.linspace(0, n, num + 1).astype(int)
    merged = np.stack([spikes[:, a:b].mean(axis=1)
                       for a, b in zip(edges[:-1], edges[1:])], axis=1)
    return t, merged


def sample_by_variance(t, spikes, num: int, filter_width=0.002, dt=None):
    """Keep the ``num`` neurons with the most variable filtered activity."""
    t = np.asarray(t)
    spikes = np.asarray(spikes)
    dt = dt or (t[1] - t[0] if len(t) > 1 else 0.001)
    a = float(np.exp(-dt / max(filter_width, dt)))
    filt = np.zeros_like(spikes, dtype=np.float64)
    acc = np.zeros(spikes.shape[1])
    for i in range(spikes.shape[0]):
        acc = a * acc + (1 - a) * spikes[i]
        filt[i] = acc
    var = filt.var(axis=0)
    idx = np.argsort(var)[::-1][: min(num, spikes.shape[1])]
    return t, spikes[:, idx]


def plot_spikes(t, spikes, ax=None, **kwargs):
    """Raster plot (black ticks) of a (T, n) spike array."""
    import matplotlib.pyplot as plt
    if ax is None:
        ax = plt.gca()
    t = np.asarray(t)
    spikes = np.asarray(spikes)
    rows, cols = np.nonzero(spikes.T)
    ax.scatter(t[cols], rows, s=kwargs.pop("s", 1), c="k", marker="|",
               **kwargs)
    ax.set_xlim(t[0], t[-1])
    ax.set_ylim(-0.5, spikes.shape[1] - 0.5)
    return ax
