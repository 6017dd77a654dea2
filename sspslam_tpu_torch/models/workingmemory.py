"""Gated working memory: a copy of
:mod:`sspslam_tpu.models.workingmemory` over the port's graph.

An integrator EnsembleArray stores a value; a gate silences the *input
network's* neurons so the stored value persists; a reset input silences the
memory itself (the inhibition goes into ``EnsembleArray.neurons``)."""

from __future__ import annotations

import numpy as np

from ..nef import Connection, EnsembleArray, Network, Node

__all__ = ["AdditiveInputGatedMemory"]


class AdditiveInputGatedMemory(Network):
    def __init__(self, inputnet, inputnet_ensembles, n_neurons, dimensions,
                 feedback=1.0, gain=1.0, recurrent_synapse=0.1,
                 difference_synapse=None, label="gatedmem", **kwargs):
        super().__init__(label=label)
        if difference_synapse is None:
            difference_synapse = recurrent_synapse

        with self:
            self.mem = EnsembleArray(n_neurons, dimensions, ens_dimensions=1,
                                     label=f"{label}_mem", **kwargs)
            Connection(self.mem.output, self.mem.input, transform=feedback,
                       synapse=recurrent_synapse)
            Connection(inputnet, self.mem.input, transform=gain,
                       synapse=difference_synapse)

            # gate inhibits the neurons of the *input* population(s)
            self.gate = Node(size_in=1)
            ens_list = (inputnet_ensembles
                        if isinstance(inputnet_ensembles, (list, tuple))
                        else [inputnet_ensembles])
            for ens in ens_list:
                Connection(self.gate, ens.neurons,
                           transform=-10.0 * np.ones((ens.n_neurons, 1)),
                           synapse=None)

            # reset silences the memory, clearing the integrator
            self.reset = Node(size_in=1)
            Connection(self.reset, self.mem.neurons,
                       transform=-3.0 * np.ones((self.mem.n_neurons, 1)),
                       synapse=None)

        self.output = self.mem.output
