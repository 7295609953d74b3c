"""Host time of the final fit (``trace/driver.py::finish_trace``: the LML
search, the fit, the prediction and the final cost): the ``gpet.finish``
spans of the profiled tail, summed, over its requests, in ms a
request."""

from gpet_bench.metrics._spans import requests, spans, total_ms


def read(record):
    got = spans(record, "gpet.finish")
    return total_ms(got) / requests(record) if got else None
