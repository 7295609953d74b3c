"""PyTorch/CUDA port of the Gaussian-process edge tracer.

A second package beside ``gaussian_process_edge_trace_tpu`` (the JAX
reference), with the same module layout and function names. It runs on one
NVIDIA GPU, where the hot stages are hand-written Hopper kernels
(``csrc/``, built with ``nvcc`` at first use), or on the CPU through the
kernels' plain PyTorch versions. It imports no JAX.

Dtype policy: float32 on the device, TF32 off for matmuls and convolutions —
the reference found that reduced-precision matmuls change which pixels get
selected.
"""

import torch

from gaussian_process_edge_trace_torch.models.tracer import GP_Edge_Tracing
from gaussian_process_edge_trace_torch.utils import (
    comp_grad_img, construct_test_img, denoise, kernel_builder, normalise,
    trace_dicecoef, trace_MSE, trace_relarea)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# GPET_DEBUG=1 turns on the NaN check of utils/debug.py at import.
import os as _os

if _os.environ.get("GPET_DEBUG") == "1":
    from gaussian_process_edge_trace_torch.utils.debug import enable_debug
    enable_debug()

__version__ = "0.1.0"

__all__ = [
    "GP_Edge_Tracing", "kernel_builder", "normalise", "comp_grad_img",
    "denoise", "construct_test_img", "trace_MSE", "trace_relarea", "trace_dicecoef",
]


def __getattr__(name):
    # The reference package's other public names (reference
    # __init__.py:10-15), imported on first use.
    if name == "GaussianProcessRegressor":
        from gaussian_process_edge_trace_torch.models.sklearn_api import (
            GaussianProcessRegressor)
        return GaussianProcessRegressor
    if name == "gpet_utils":
        from gaussian_process_edge_trace_torch import utils as gpet_utils
        return gpet_utils
    raise AttributeError(name)
