"""Serving many traces: batches, ensembles, edges and sequences on one
device, and batches sharded over a (data, sample) mesh of processes."""

from gaussian_process_edge_trace_torch.parallel.sharded import (  # noqa: F401
    make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
    trace_batch, trace_ensemble, trace_multi_edge, trace_sequence)
