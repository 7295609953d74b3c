"""The 95th percentile of every request's wall time in the window, in ms:
from handing the gradient image to the entry point until the trace and its
interval are on the host. Requests of one trace only."""

import sys

import numpy as np


def read(record):
    if record["entry"] != "single":
        return None
    walls = [r["wall_s"] * 1e3 for r in record["requests"]]
    print(f"trace_ms_p95 over {len(walls)} requests "
          f"({len(walls) - int(0.95 * len(walls))} beyond it)",
          file=sys.stderr)
    return float(np.percentile(walls, 95))
