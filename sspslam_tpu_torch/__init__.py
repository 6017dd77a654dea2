"""sspslam_tpu_torch — the PyTorch / CUDA (Hopper) port of sspslam_tpu.

The port mirrors the JAX package's module paths and public names; the JAX
package stays the reference it is tested against.  This package imports
``torch``, ``numpy`` and ``scipy`` and never JAX.  Ported so far: the SSP
spaces, the NEF engine (builder, executor and ``Simulator``, which replays
the step as CUDA graphs on the card), ``PathIntegration``, the binding
networks and the associative memory, the path-integration fast path
``FastPathIntegrator`` with its VCO-bank CUDA kernel (``csrc/vco_scan.cu``),
``SLAMNetwork`` with its clean-up, correction gates and input adapters, and
``python -m sspslam_tpu_torch.experiments.run_pathint`` / ``run_slam``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from .sspspace import (HexagonalSSPSpace, RandomSSPSpace,
                       RectangularSSPSpace, SPSpace, SSPSpace)
from . import models, nef, ops, utils
from .models import FastPathIntegrator, PathIntegration, SLAMNetwork

__all__ = ["SPSpace", "SSPSpace", "RandomSSPSpace", "HexagonalSSPSpace",
           "RectangularSSPSpace", "models", "nef", "ops", "utils",
           "FastPathIntegrator", "PathIntegration", "SLAMNetwork"]
