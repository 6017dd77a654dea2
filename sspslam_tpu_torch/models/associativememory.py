"""Heteroassociative memory: Voja-learned encoders + PES-learned decoders.

A copy of :mod:`sspslam_tpu.models.associativememory` over the port's
graph (reference associativememory.py:11-54): a ``memory``
population with selective (high-intercept) tuning encodes keys; Voja pulls
active encoders toward presented keys; PES trains the memory->recall decoders
from an error population that is inhibited when learning is gated off.
The learned weights live in the simulation state (checkpointable).
"""

from __future__ import annotations

import numpy as np

from ..nef import Connection, Ensemble, Network, Node, PES, Voja

__all__ = ["AssociativeMemory"]


class AssociativeMemory(Network):
    """Learnable key->value map.

    Inputs: ``key_input`` (d_key), ``value_input`` (d_value), ``learning``
    (scalar; 0 = learn, large positive = frozen — it inhibits the error
    population and is the Voja gate).  Output: ``recall`` ensemble.
    """

    def __init__(self, n_neurons, d_key, d_value, intercept,
                 voja_learning_rate=5e-2, pes_learning_rate=1e-3,
                 encoders=None, radius=1, voja=True, tau=0.05,
                 label="assomemory", seed=None, **kwargs):
        super().__init__(label=label, seed=seed)
        with self:
            self.key_input = Node(size_in=d_key, label="memory_input")
            self.value_input = Node(size_in=d_value)
            self.learning = Node(size_in=1)
            self.recall = Ensemble(n_neurons, d_value, label="memory_recall")

            self.memory = Ensemble(
                n_neurons, d_key, intercepts=float(intercept),
                encoders=encoders, radius=radius, label="memory",
                normalize_encoders=True)

            if voja:
                self.conn_in = Connection(
                    self.key_input, self.memory, synapse=None,
                    learning_rule_type=Voja(voja_learning_rate,
                                            post_synapse=None),
                    label="map_conn_in")
                Connection(self.learning, self.conn_in.learning_rule,
                           synapse=None)
            else:
                self.conn_in = Connection(self.key_input, self.memory,
                                          synapse=None, label="map_conn_in")

            # decoders start at the null function; PES shapes them online
            self.conn_out = Connection(
                self.memory, self.recall,
                function=lambda x: np.zeros(d_value),
                learning_rule_type=PES(pes_learning_rate),
                label="map_conn_pes")

            # error = recall - value, silenced when learning is gated off
            self.error = Ensemble(n_neurons, d_value, label="memory_pes_error")
            Connection(self.learning, self.error.neurons,
                       transform=-2.5 * np.ones((n_neurons, 1)), synapse=None)
            Connection(self.value_input, self.error, transform=-1, synapse=tau)
            Connection(self.recall, self.error, synapse=tau)
            Connection(self.error, self.conn_out.learning_rule, synapse=tau)
