"""Drop-in alias for the reference's ``gp_edge_tracing.gpet`` module
(reference __init__.py:10-15; README.md:61 imports ``gpet`` and calls
``gpet.GP_Edge_Tracing``)."""

from gaussian_process_edge_trace_torch.models.tracer import (  # noqa: F401
    GP_Edge_Tracing)
from gaussian_process_edge_trace_torch.trace.driver import (  # noqa: F401
    TraceResult, TracerConfig, TracerData, TraceState, init_state,
    make_config, make_data, run_trace)
