"""Share of the loop's scoring, KDE and selection stages that replayed their
CUDA graphs: the ``gpet.score.replay``, ``gpet.kde.replay`` and
``gpet.select.replay`` spans (``trace/stage_graph.py::run`` in the
program) inside ``gpet.iter`` spans of the profiled tail, over the
``gpet.score``, ``gpet.kde`` and ``gpet.select`` spans inside them, in
percent; None where the profile holds no such replay span (a program
without these graphs)."""

from gpet_bench.metrics._spans import ITER, inside, spans

STAGES = ("gpet.score", "gpet.kde", "gpet.select")


def read(record):
    iters = spans(record, ITER)
    replays = sum(len(inside(spans(record, s + ".replay"), iters))
                  for s in STAGES)
    stages = sum(len(inside(spans(record, s), iters)) for s in STAGES)
    if not replays or not stages:
        return None
    return 100.0 * replays / stages
