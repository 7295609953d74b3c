"""Helpers that the span readers share (not a metric): the program's own
``gpet.*`` spans (``utils/profiling.py::span`` in the program) in the
profiled tail's timeline, on the clock of its kernels.

A span is a host event ``(name, start_us, dur_us)`` of
``profile.Timeline.host``. A stage span counts only where it starts inside
a ``gpet.iter`` span; every reader returns None where the profile holds
none of the spans it reads (a program without them)."""

from __future__ import annotations

import bisect

ITER = "gpet.iter"
WAIT = "gpet.wait."


def timeline(record):
    """The profiled tail's timeline, or None."""
    prof = record.get("profile")
    return prof["timeline"] if prof else None


def spans(record, name, prefix=False):
    """``[(start_us, end_us)]`` of the spans named ``name`` (or whose name
    starts with it, with ``prefix``), sorted by start."""
    t = timeline(record)
    if t is None:
        return []
    return sorted((s, s + d) for n, s, d in t.host
                  if (n.startswith(name) if prefix else n == name))


def inside(inner, outer):
    """The spans of ``inner`` that start inside one of ``outer`` (both
    sorted lists of ``(start, end)``; ``outer`` does not overlap
    itself)."""
    starts = [a for a, _ in outer]
    out = []
    for a, b in inner:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < outer[i][1]:
            out.append((a, b))
    return out


def total_ms(intervals):
    return sum(b - a for a, b in intervals) / 1e3


def per_iter_ms(record, name):
    """The ``name`` spans inside ``gpet.iter`` spans, their summed
    duration over the number of ``gpet.iter`` spans, in ms; None where
    there are no ``gpet.iter`` spans or none of ``name`` in them."""
    iters = spans(record, ITER)
    got = inside(spans(record, name), iters)
    if not iters or not got:
        return None
    return total_ms(got) / len(iters)


def requests(record):
    """The number of profiled requests."""
    return len(record["profile"]["requests"])
