"""Serving many traces at once on one device: frames, ensembles, edges."""

from gaussian_process_edge_trace_torch.parallel.sharded import (  # noqa: F401
    make_batch_data, make_batch_state, trace_batch, trace_ensemble,
    trace_multi_edge)
