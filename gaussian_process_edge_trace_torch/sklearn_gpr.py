"""Drop-in alias for the reference's vendored ``sklearn_gpr`` module
(reference sklearn_gpr.py:31-610,617-721): the GaussianProcessRegressor and
its kernel objects."""

from gaussian_process_edge_trace_torch.models.sklearn_api import (  # noqa: F401
    ConstantKernel, GaussianProcessRegressor, Matern, RBF,
    WeightedWhiteKernel)
