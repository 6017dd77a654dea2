from .associativememory import AssociativeMemory
from .binding import (CircularConvolution, Product, circconv,
                      dot_product_transform)
from .fast_pathint import FastPathIntegrator
from .pathintegration import (PathIntegration, get_from_Fourier,
                              get_to_Fourier, vco_feedback)

__all__ = ["AssociativeMemory", "CircularConvolution", "FastPathIntegrator",
           "PathIntegration", "Product", "circconv", "dot_product_transform",
           "get_from_Fourier", "get_to_Fourier", "vco_feedback"]
