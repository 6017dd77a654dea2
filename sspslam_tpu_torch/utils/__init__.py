from .sampling import (
    Rd_sampling,
    get_mean_and_ci,
    random_orthogonal,
    scattered_hypersphere,
    sparsity_to_x_intercept,
    spherical_transform,
    uniform_hypersphere,
)

__all__ = [
    "Rd_sampling",
    "get_mean_and_ci",
    "random_orthogonal",
    "scattered_hypersphere",
    "sparsity_to_x_intercept",
    "spherical_transform",
    "uniform_hypersphere",
]
