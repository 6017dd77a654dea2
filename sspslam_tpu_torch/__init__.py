"""sspslam_tpu_torch — the PyTorch / CUDA (Hopper) port of sspslam_tpu.

The port mirrors the JAX package's module paths and public names; the JAX
package stays the reference it is tested against.  This package imports
``torch``, ``numpy`` and ``scipy`` and never JAX.  Ported so far: the SSP
spaces and the VSA algebra; the NEF engine (builder, executor and
``Simulator``, which replays the step as CUDA graphs on the card) with
float32, bf16 and 1-byte (int8 / fp8, ``ops.quantize``) parameter storage;
batched episodes of one built model (``parallel.run_batched_episodes``,
the step under ``torch.func.vmap``, also captured as CUDA graphs); the
path-integration networks and their fast path ``FastPathIntegrator`` with
its VCO-bank CUDA kernel (``csrc/vco_scan.cu``); the binding networks, the
associative and working memories; ``SLAMNetwork``, ``SLAMGatedNetwork`` and
``SLAMViewNetwork`` with their clean-ups, correction gates and input
adapters; and the CLIs ``python -m sspslam_tpu_torch.experiments.<name>``
for ``run_pathint``, ``run_slam``, ``run_slamview`` and ``scaled_slam``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from .version import version as __version__

from .sspspace import (HexagonalSSPSpace, RandomSSPSpace,
                       RectangularSSPSpace, SPSpace, SSPSpace)
from . import models, nef, ops, parallel, utils
from .models import (AssociativeMemory, CircularConvolution,
                     FastPathIntegrator, PathIntegration, Product,
                     SLAMGatedNetwork, SLAMNetwork, SLAMViewNetwork)
# the reference package's layout also names the models module `networks`
networks = models

__all__ = ["SPSpace", "SSPSpace", "RandomSSPSpace", "HexagonalSSPSpace",
           "RectangularSSPSpace", "models", "networks", "nef", "ops",
           "parallel", "utils", "AssociativeMemory", "CircularConvolution",
           "FastPathIntegrator", "PathIntegration", "Product",
           "SLAMGatedNetwork", "SLAMNetwork", "SLAMViewNetwork",
           "__version__"]
