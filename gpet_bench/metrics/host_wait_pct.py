"""The share of the profiled window the host spends waiting for the
device: the ``gpet.wait.<kind>`` spans' summed duration over the window,
in percent."""

from gpet_bench.metrics._spans import WAIT, spans, timeline, total_ms


def read(record):
    got = spans(record, WAIT, prefix=True)
    if not got:
        return None
    return 100.0 * total_ms(got) / (1e3 * timeline(record).window_s)
