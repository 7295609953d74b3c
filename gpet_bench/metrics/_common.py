"""Helpers that the metric readers share (not a metric)."""

from __future__ import annotations

from gpet_bench import work


def loop_iterations(req):
    """Iterations of a request's loop: its longest frame's."""
    return max(req["n_iters"])


def active_frames(req, k):
    """Frames of a request still active at iteration ``k``."""
    return sum(1 for n in req["n_iters"] if n > k)


def kernel_seconds(timeline, names):
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(d for n, _, _, d in timeline.kernels()
               if any(s in n for s in names)) / 1e6


def roofline_pct(record, names, work_fn):
    """Percent of the least time: the bound of ``work_fn(req, k)`` summed
    over each profiled request's iterations, over the kernels' device
    time; None where the profile holds none of them."""
    prof = record.get("profile")
    if not prof:
        return None
    t = kernel_seconds(prof["timeline"], names)
    if t <= 0:
        return None
    least = sum(work.bound(*work_fn(req, k))[0]
                for req in prof["requests"]
                for k in range(loop_iterations(req)))
    return 100.0 * least / t
