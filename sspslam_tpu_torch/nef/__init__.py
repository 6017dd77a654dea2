"""NEF engine, PyTorch port: declarative graph -> built parameters.

The graph, distributions and builder of :mod:`sspslam_tpu.nef`; the
executor and ``Simulator`` are not ported yet.
"""

from ..ops.neurons import LIF, LIFRate
from ..ops.synapses import Alpha, Lowpass
from .builder import Model, build
from .distributions import (Choice, CosineSimilarity, Distribution,
                            Exponential, Rd, ScatteredHypersphere, Sobol,
                            SSPMixedEval, SSPSobol, Uniform,
                            UniformHypersphere)
from .graph import (BatchedConnection, Connection, Default, Ensemble,
                    EnsembleArray, LearningRule, Network, Neurons, Node,
                    ObjView, PES, Probe, Voja)

__all__ = [
    "LIF", "LIFRate", "Alpha", "Lowpass", "Model", "build",
    "Choice", "CosineSimilarity", "Distribution", "Exponential",
    "Rd", "ScatteredHypersphere", "Sobol", "SSPMixedEval", "SSPSobol",
    "Uniform", "UniformHypersphere",
    "BatchedConnection", "Connection", "Default", "Ensemble", "EnsembleArray",
    "LearningRule", "Network", "Neurons", "Node", "ObjView", "PES", "Probe",
    "Voja",
]
