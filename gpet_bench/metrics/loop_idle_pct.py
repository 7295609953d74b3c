"""The device's idle share inside the loop's iterations: 1 minus the
union of device activity (kernels, copies, sets) inside the ``gpet.iter``
spans of the profiled tail over their summed duration, in percent. Beside
``device_idle_pct`` it tells idle inside the loop body, where the host's
launches set the pace, from idle at the loop's edges (the constructor, the
final fit, the waits)."""

from gpet_bench.metrics._spans import ITER, spans, timeline


def read(record):
    iters = spans(record, ITER)
    if not iters:
        return None
    busy = timeline(record).busy_intervals()
    covered, j = 0.0, 0
    for a, b in iters:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return 100.0 * (1.0 - covered / sum(b - a for a, b in iters))
