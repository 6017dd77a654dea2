"""NEF engine, PyTorch port: declarative graph -> built parameters ->
stepped simulation.

The graph, distributions, builder, processes, executor and ``Simulator`` of
:mod:`sspslam_tpu.nef`.  Not ported: ``ClosedLoopSession``, the export
bundle and the NumPy reference interpreter.
"""

from ..ops.neurons import (LIF, LIFRate, LoihiLIF, QuantizedLIF,
                           RectifiedLinear, SpikingRectifiedLinear)
from ..ops.synapses import Alpha, Lowpass
from .builder import Model, build
from .distributions import (Choice, CosineSimilarity, Distribution,
                            Exponential, Rd, ScatteredHypersphere, Sobol,
                            SSPMixedEval, SSPSobol, Uniform,
                            UniformHypersphere)
from .graph import (BatchedConnection, Connection, Default, Ensemble,
                    EnsembleArray, LearningRule, Network, Neurons, Node,
                    ObjView, PES, Probe, Voja)
from .processes import TimeTable, WhiteSignal, clamp_table, white_signal
from .simulator import Simulator

__all__ = [
    "LIF", "LIFRate", "LoihiLIF", "QuantizedLIF", "RectifiedLinear",
    "SpikingRectifiedLinear", "Alpha", "Lowpass", "Model", "build",
    "Choice", "CosineSimilarity", "Distribution", "Exponential",
    "Rd", "ScatteredHypersphere", "Sobol", "SSPMixedEval", "SSPSobol",
    "Uniform", "UniformHypersphere",
    "BatchedConnection", "Connection", "Default", "Ensemble", "EnsembleArray",
    "LearningRule", "Network", "Neurons", "Node", "ObjView", "PES", "Probe",
    "Voja", "TimeTable", "WhiteSignal", "clamp_table", "white_signal",
    "Simulator",
]
