from .fast_pathint import FastPathIntegrator
from .pathintegration import (PathIntegration, get_from_Fourier,
                              get_to_Fourier, vco_feedback)

__all__ = ["FastPathIntegrator", "PathIntegration", "get_from_Fourier",
           "get_to_Fourier", "vco_feedback"]
