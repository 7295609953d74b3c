"""Host time of a batch's per-frame library calls in the loop: the
``gpet.frame_by_frame`` spans (``models/gpr.py::frame_by_frame`` on the
card with more than one frame) inside ``gpet.iter`` spans of the profiled
tail, summed, over the number of ``gpet.iter`` spans, in ms."""

from gpet_bench.metrics._spans import per_iter_ms


def read(record):
    return per_iter_ms(record, "gpet.frame_by_frame")
