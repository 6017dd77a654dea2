"""sspslam_tpu_torch — the PyTorch / CUDA (Hopper) port of sspslam_tpu.

The port mirrors the JAX package's module paths and public names; the JAX
package stays the reference it is tested against.  This package imports
``torch``, ``numpy`` and ``scipy`` and never JAX.  Ported so far: the
path-integration fast path (SSP spaces, the NEF builder, ``PathIntegration``
and ``FastPathIntegrator``) with its VCO-bank CUDA kernel
(``csrc/vco_scan.cu``).
"""

from .sspspace import HexagonalSSPSpace, SSPSpace
from . import models, nef, ops, utils
from .models import FastPathIntegrator, PathIntegration

__all__ = ["SSPSpace", "HexagonalSSPSpace", "models", "nef", "ops", "utils",
           "FastPathIntegrator", "PathIntegration"]
