"""Online learning rules as pure state-update functions on torch tensors.

Port of :mod:`sspslam_tpu.ops.learning`: PES (decoder learning) and Voja
(encoder drift), the rules the reference's AssociativeMemory trains with
(associativememory.py:30-43).  Each returns a new tensor and leaves its
inputs untouched, so the executor can read the old weights after the
update.
"""

from __future__ import annotations

import torch

__all__ = ["pes_update", "voja_update"]


def pes_update(decoders, activities, error, learning_rate, dt,
               n_neurons=None):
    """PES decoder update.

    decoders : (n, d) current decoders (value = activities @ decoders).
    activities : (n,) filtered presynaptic activities.
    error : (d,) error signal (recall - target convention: the rule moves the
        decoded value *down* the error).
    Delta = -(learning_rate * dt / n) * outer(activities, error).
    ``learning_rate`` may be a tensor (the executor keeps it in its params,
    so changing it needs no new step function).
    ``n_neurons``: LOGICAL neuron count for the rate normalisation — pass
    it when the decoder rows include phantom padding neurons.
    """
    n = n_neurons if n_neurons is not None else decoders.shape[0]
    alpha = learning_rate * dt / n
    return decoders - alpha * torch.outer(activities, error)


def voja_update(scaled_encoders, activities, pre_value, learning_signal,
                scale, learning_rate, dt):
    """Voja scaled-encoder update.

    scaled_encoders : (n, d) = encoders * (gain / radius)[:, None].
    activities : (n,) postsynaptic activities.
    pre_value : (d,) key vector driving the ensemble.
    learning_signal : scalar; 1 + (gating input) — learning proceeds at a rate
        proportional to this (0 disables).
    scale : (n,) per-neuron gain/radius, the magnitude each encoder row is
        pulled toward.
    """
    alpha = learning_rate * dt * learning_signal
    delta = alpha * (scale[:, None] * torch.outer(activities, pre_value)
                     - activities[:, None] * scaled_encoders)
    return scaled_encoders + delta
