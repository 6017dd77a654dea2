from .associativememory import AssociativeMemory
from .binding import (CircularConvolution, Product, circconv,
                      dot_product_transform)
from .fast_pathint import FastPathIntegrator
from .pathintegration import (PathIntegration, get_from_Fourier,
                              get_to_Fourier, vco_feedback)
from .slam import (SLAMNetwork, get_anchor_input_functions,
                   get_slam_input_functions, get_slam_input_functions2)

__all__ = ["AssociativeMemory", "CircularConvolution", "FastPathIntegrator",
           "PathIntegration", "Product", "circconv", "dot_product_transform",
           "get_from_Fourier", "get_to_Fourier", "vco_feedback",
           "SLAMNetwork", "get_slam_input_functions",
           "get_slam_input_functions2", "get_anchor_input_functions"]
