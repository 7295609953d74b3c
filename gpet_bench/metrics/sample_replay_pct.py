"""Share of the loop's sampling stages that replayed their CUDA graph: the
``gpet.sample.replay`` spans (``trace/driver.py::_sample_stage`` in the
program) inside ``gpet.iter`` spans of the profiled tail, over the
``gpet.sample`` spans inside them, in percent; None where the profile
holds no replay span (a program without the graph)."""

from gpet_bench.metrics._spans import ITER, inside, spans


def read(record):
    iters = spans(record, ITER)
    replays = inside(spans(record, "gpet.sample.replay"), iters)
    stages = inside(spans(record, "gpet.sample"), iters)
    if not replays or not stages:
        return None
    return 100.0 * len(replays) / len(stages)
