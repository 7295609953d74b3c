"""Input utilities: synthetic images, preprocessing and trace metrics."""

from gaussian_process_edge_trace_torch.utils.image import (  # noqa: F401
    comp_grad_img, kernel_builder, normalise)
from gaussian_process_edge_trace_torch.utils.metrics import (  # noqa: F401
    trace_dicecoef, trace_MSE)
from gaussian_process_edge_trace_torch.utils.synthetic import (  # noqa: F401
    construct_test_img)
