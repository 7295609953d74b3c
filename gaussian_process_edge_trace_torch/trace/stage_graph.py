"""A stage of the tracing loop replayed from one CUDA graph.

The loop's sampling stage (``trace/driver.py::_sample_stage``: the padded
training buffers and the sampling round) is ~140 PyTorch operators and
hand-written kernels an iteration, each a few µs on the card, so the host's
launches set its pace. Its inputs have shapes that the configuration fixes,
and its work is kernels alone: no host read, no blocking copy, no
allocation outside PyTorch's allocator. So it is captured once per key as
one CUDA graph over static input buffers, and replayed:

- :func:`engaged` says whether a stage on a device may replay a graph: on
  the card, outside any ``TorchDispatchMode`` (``utils/debug.py``'s NaN
  check reads every output back).
- :func:`lookup` gives the :class:`StageGraph` of a key, or None for a key
  whose capture raised: that failure is counted once (``GRAPHS["failed"]``)
  and warned of, and the key runs op by op from then on.
- A :class:`StageGraph` copies its inputs into its static buffers, skipping
  an input that is already there (the buffer itself, written in place by
  its producer, or the tensor copied last time, at the same version). Its
  first call runs the stage op by op on a side stream, which gives that
  call's output, and captures it; every later call replays the graph, in
  its span, and returns the graph's output buffer, which the next replay
  overwrites.

The cache is per process, so a new request of a configuration already
seen replays without a capture. At most :data:`MAX_GRAPHS` are kept, the
least recently used dropped; each holds its own memory pool, the stage's
intermediates included. A replay adds to ``LAUNCHES`` and ``BLOCKED`` what
its capture launched, so the counters read as if the stage ran op by op.
"""

from __future__ import annotations

import collections
import warnings

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from gaussian_process_edge_trace_torch.utils import profiling
from gaussian_process_edge_trace_torch.utils.profiling import GRAPHS, span

# Graphs kept per process: a process serves a few shapes (a single trace's,
# a batch's), and each graph holds its stage's memory.
MAX_GRAPHS = 8

_graphs: collections.OrderedDict = collections.OrderedDict()


def engaged(device) -> bool:
    """Whether a stage on ``device`` may replay a graph."""
    return device.type == "cuda" and _get_current_dispatch_mode() is None


def _version(t):
    """``t``'s version counter, bumped by every in-place write; None for an
    inference tensor, which keeps none (so it is copied every time)."""
    return None if t.is_inference() else t._version


def _kernel_counts() -> dict:
    return {k: v for k, v in profiling.counters().items()
            if k.startswith(("LAUNCHES.", "BLOCKED."))}


class StageGraph:
    """``fn(*inputs)`` (tensors on one card, returning a tensor) as one CUDA
    graph over static copies of ``inputs`` (``example``: tensors of their
    shapes and dtypes), each replay in the span ``name``."""

    def __init__(self, fn, example, name):
        self.fn, self.name = fn, name
        self.device = example[0].device
        self.static = [t.clone() for t in example]
        self._held = [(t, _version(t)) for t in example]
        self.graph = None
        self.failed = False

    def _load(self, inputs):
        for i, (src, dst) in enumerate(zip(inputs, self.static)):
            held, version = self._held[i]
            if src is dst or (src is held and version is not None
                              and _version(src) == version):
                continue
            dst.copy_(src)
            self._held[i] = (src, _version(src))

    def _capture(self):
        """Run ``fn`` op by op on a side stream, then capture it there
        under ``torch.cuda.graph``; returns the first run's output. A
        capture that raises leaves the graph unset and ``failed`` true."""
        with torch.cuda.device(self.device):
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                out = self.fn(*self.static)
            here.wait_stream(side)
            out.record_stream(here)
            before = _kernel_counts()
            graph = torch.cuda.CUDAGraph()
            # The outer stream context restores the caller's stream also
            # where ``torch.cuda.graph``'s exit raises before its own does.
            try:
                with torch.cuda.stream(side), torch.cuda.graph(
                        graph, stream=side,
                        capture_error_mode="thread_local"):
                    self.out = self.fn(*self.static)
                self.graph = graph
                GRAPHS["capture"] += 1
            except RuntimeError as exc:
                self.failed = True
                GRAPHS["failed"] += 1
                warnings.warn(f"the stage runs op by op: its CUDA graph "
                              f"capture raised {exc}", RuntimeWarning,
                              stacklevel=2)
            finally:
                # A capture launches nothing: its counts come back with
                # each replay.
                after = _kernel_counts()
                self.launches = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
                profiling.add_counts({k: -n for k, n in
                                      self.launches.items()})
        return out

    def __call__(self, inputs):
        """The stage on ``inputs`` (tensors of the captured shapes and
        dtypes): the first call's own output, then the graph's buffer."""
        self._load(inputs)
        if self.graph is None:
            return self._capture()
        with span(self.name), torch.cuda.device(self.device):
            self.graph.replay()
        profiling.add_counts(self.launches)
        GRAPHS["replay"] += 1
        return self.out


def lookup(key, build, name):
    """The :class:`StageGraph` of ``key`` (hashable: everything the
    stage's Python reads), made from ``build()`` = ``(fn, example)`` at the
    key's first use, its replays in the span ``name``; None for a key whose
    capture failed."""
    graph = _graphs.get(key)
    if graph is None:
        graph = StageGraph(*build(), name)
        _graphs[key] = graph
        if len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
    else:
        _graphs.move_to_end(key)
    return None if graph.failed else graph


def clear():
    """Drop every kept graph, and with it every key's capture or failure."""
    _graphs.clear()
