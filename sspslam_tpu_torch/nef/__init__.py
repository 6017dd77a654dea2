"""NEF engine, PyTorch port: declarative graph -> built parameters ->
stepped simulation.

The graph, distributions, builder, processes, executor, ``Simulator``,
``ClosedLoopSession``, the serving bundle (``save_bundle``,
``ServingModel``) and the NumPy reference interpreter
(``reference_backend.NumpyStepper``) of :mod:`sspslam_tpu.nef`.
"""

from ..ops.neurons import (LIF, LIFRate, LoihiLIF, QuantizedLIF,
                           RectifiedLinear, SpikingRectifiedLinear,
                           SurrogateLIF)
from ..ops.synapses import Alpha, Lowpass
from .builder import Model, build
from .distributions import (Choice, CosineSimilarity, Distribution,
                            Exponential, Rd, ScatteredHypersphere, Sobol,
                            SSPMixedEval, SSPSobol, Uniform,
                            UniformHypersphere)
from .export import ServingModel, save_bundle
from .graph import (BatchedConnection, Connection, Default, Ensemble,
                    EnsembleArray, LearningRule, Network, Neurons, Node,
                    ObjView, PES, Probe, Voja)
from .processes import TimeTable, WhiteSignal, clamp_table, white_signal
from .realtime import ClosedLoopSession
from .simulator import Simulator

__all__ = [
    "LIF", "LIFRate", "LoihiLIF", "QuantizedLIF", "RectifiedLinear",
    "SpikingRectifiedLinear", "SurrogateLIF", "Alpha", "Lowpass", "Model", "build",
    "Choice", "CosineSimilarity", "Distribution", "Exponential",
    "Rd", "ScatteredHypersphere", "Sobol", "SSPMixedEval", "SSPSobol",
    "Uniform", "UniformHypersphere",
    "BatchedConnection", "Connection", "Default", "Ensemble", "EnsembleArray",
    "LearningRule", "Network", "Neurons", "Node", "ObjView", "PES", "Probe",
    "Voja", "TimeTable", "WhiteSignal", "clamp_table", "white_signal",
    "ClosedLoopSession", "Simulator", "ServingModel", "save_bundle",
]
