"""Host time of the loop's KDE stage (the kept curves' weights and their
density on the pixel grid): the ``gpet.kde`` spans inside ``gpet.iter``
spans of the profiled tail, summed, over the number of ``gpet.iter``
spans (the loop's iterations; a batch steps its frames at once), in ms."""

from gpet_bench.metrics._spans import per_iter_ms


def read(record):
    return per_iter_ms(record, "gpet.kde")
