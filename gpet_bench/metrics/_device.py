"""Helpers that the device-time readers share (not a metric): the device
operations of the loop's iterations in the profiled tail, whenever the
device ran them.

The program's loop (``trace/driver.py::run_loop``) reads its active mask
once before the first iteration and once at the end of each ``gpet.iter``
span, each read a ``gpet.wait.active`` span that waits for the device's
stream. Between a read's end and the next ``gpet.iter`` span it launches
nothing. So the operations that run between the end of the read before an
``gpet.iter`` span and the end of the last read inside it are those
launched inside the span, however long after the host's stages closed they
ran: an operation belongs to the iteration whose interval holds its
midpoint. Where an iteration has no read before it or inside it (a program
without these waits), every reader returns None.

Nothing here ties an operation to the stage (``gpet.sample`` …) that
launched it: that takes the profiler's launch events and their correlation
ids, which ``profile.record`` does not keep."""

from __future__ import annotations

import bisect

from gpet_bench.metrics._common import loop_iterations
from gpet_bench.metrics._spans import ITER, spans, timeline

ACTIVE = "gpet.wait.active"


def iteration_windows(record):
    """``[(start_us, end_us)]`` of each ``gpet.iter`` span's device
    interval: from the end of the read before it to the end of the last
    read inside it; None where there is no profile, no iteration, or an
    iteration without those reads."""
    if timeline(record) is None:
        return None
    iters = spans(record, ITER)
    ends = sorted(b for _, b in spans(record, ACTIVE))
    out = []
    for a, b in iters:
        i, j = bisect.bisect_right(ends, a), bisect.bisect_right(ends, b)
        if i == 0 or j == i:
            return None
        out.append((ends[i - 1], ends[j - 1]))
    return out or None


def loop_ops(record):
    """``([(name, cat, dur_us)], n_iters)``: the device operations that
    ran in the loop's iterations and the number of ``gpet.iter`` spans;
    None where :func:`iteration_windows` is."""
    windows = iteration_windows(record)
    if windows is None:
        return None
    starts = [a for a, _ in windows]
    out = []
    for name, cat, s, d in timeline(record).device:
        mid = s + 0.5 * d
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= windows[i][1]:
            out.append((name, cat, d))
    return out, len(windows)


def iter_ms(record, keep):
    """The device time of the loop's operations for which ``keep(name,
    cat)`` holds, over the number of ``gpet.iter`` spans, in ms; None
    where :func:`loop_ops` is."""
    got = loop_ops(record)
    if got is None:
        return None
    ops, n = got
    return sum(d for name, cat, d in ops if keep(name, cat)) / 1e3 / n


def frame_nobs(req, f, k, n_inits):
    """Frame ``f``'s valid training points at iteration ``k``: its
    endpoints and the observations it had accepted after iteration k−1."""
    return n_inits + (int(req["iter_nobs"][f][k - 1]) if k else 0)


def roofline_pct(record, names, least_s):
    """Percent of the least time: ``least_s(req, k, frames)`` (seconds)
    summed over each profiled request's iterations, ``frames`` the indices
    of the frames active at iteration ``k``, over the device time of the
    loop's kernels whose name holds one of ``names``; None where there are
    none."""
    got = loop_ops(record)
    if got is None:
        return None
    t = sum(d for n, c, d in got[0]
            if c == "kernel" and any(s in n for s in names)) / 1e6
    if t <= 0:
        return None
    least = 0.0
    for req in record["profile"]["requests"]:
        for k in range(loop_iterations(req)):
            frames = [f for f, n in enumerate(req["n_iters"]) if n > k]
            least += least_s(req, k, frames)
    return 100.0 * least / t
