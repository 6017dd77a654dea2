from .sampling import (
    Rd_sampling,
    get_mean_and_ci,
    random_orthogonal,
    scattered_hypersphere,
    sparsity_to_x_intercept,
    spherical_transform,
    uniform_hypersphere,
)
from . import figure_utils
from . import spikes
from .figure_utils import save
from .network_diagram import network_diagram, process_and_save_diagram

__all__ = [
    "Rd_sampling",
    "get_mean_and_ci",
    "random_orthogonal",
    "scattered_hypersphere",
    "sparsity_to_x_intercept",
    "spherical_transform",
    "uniform_hypersphere",
    "figure_utils",
    "spikes",
    "save",
    "network_diagram",
    "process_and_save_diagram",
]
