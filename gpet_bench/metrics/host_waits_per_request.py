"""The host's waits for the device: the ``gpet.wait.<kind>`` spans of the
profiled tail (every read of a device value by the host, and every
blocking copy to the device, each of which first drains the stream), over
its requests."""

from gpet_bench.metrics._spans import WAIT, requests, spans


def read(record):
    got = spans(record, WAIT, prefix=True)
    return len(got) / requests(record) if got else None
