"""A stage of the tracing loop replayed from one CUDA graph.

Each stage of an iteration (``trace/driver.py::_iteration``: sampling,
scoring, KDE, selection) is tens to ~140 PyTorch operators and
hand-written kernels, each a few µs on the card, so the host's launches
set its pace. Its inputs have shapes that the configuration fixes, and its
work is kernels alone: no host read, no blocking copy, no allocation
outside PyTorch's allocator. So it is captured once per key as one CUDA
graph over static input buffers, and replayed:

- :func:`engaged` says whether a stage on a device may replay a graph: on
  the card, outside any ``TorchDispatchMode`` (``utils/debug.py``'s NaN
  check reads every output back).
- :func:`lookup` gives the :class:`StageGraph` of a key, or None for a key
  whose capture raised: that failure is counted once (``GRAPHS["failed"]``)
  and warned of, and the key runs op by op from then on. :func:`run` is a
  stage through it: replayed where engaged, else op by op.
- A :class:`StageGraph` copies its inputs into its static buffers, skipping
  an input that is already there (the buffer itself, written in place by
  its producer, or the tensor copied last time, at the same version). An
  input that is another graph's output buffer (:func:`produced`; the
  previous stage's) may be taken as the static buffer itself, with no
  copy: its identity is then part of the key. Any other graph output is
  copied at every call, since a replay rewrites it without bumping its
  version. The first call runs the stage op by op on a side stream, which
  loads its kernels, captures it, and replays it; every call replays the
  graph, in its span, and returns the graph's output buffers (a tensor or
  a tuple), which its next replay overwrites: a caller that keeps one
  copies it.

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

# Graphs kept per process: each of the loop's four stages for a few shapes
# at once (a single trace's, a batch's), each graph holding its stage's
# memory.
MAX_GRAPHS = 16

_graphs: collections.OrderedDict = collections.OrderedDict()
# The output buffers of the kept graphs, by id.
_produced: dict = {}


def engaged(device) -> bool:
    """Whether a stage on ``device`` may replay a graph."""
    return device.type == "cuda" and _get_current_dispatch_mode() is None


def produced(t) -> bool:
    """Whether ``t`` is an output buffer of a kept graph, which its next
    replay overwrites."""
    return _produced.get(id(t)) is t


def _version(t):
    """``t``'s version counter, bumped by every in-place write; None for an
    inference tensor, which keeps none (so it is copied every time)."""
    return None if t.is_inference() else t._version


def _kernel_counts() -> dict:
    return {k: v for k, v in profiling.counters().items()
            if k.startswith(("LAUNCHES.", "BLOCKED."))}


class StageGraph:
    """``fn(*inputs)`` (tensors on one card, returning a tensor or a tuple
    of tensors) as one CUDA graph over static copies of ``inputs``
    (``example``: tensors of their shapes and dtypes; those at the
    positions ``shared`` are taken as the static buffers themselves), each
    replay in the span ``name``."""

    def __init__(self, fn, example, name, shared=()):
        self.fn, self.name = fn, name
        self.device = example[0].device
        self.static = [t if i in shared else t.clone()
                       for i, t in enumerate(example)]
        self._held = [(t, _version(t)) for t in example]
        self.graph = None
        self.failed = False

    def _load(self, inputs):
        for i, (src, dst) in enumerate(zip(inputs, self.static)):
            held, version = self._held[i]
            if src is dst or (src is held and version is not None
                              and _version(src) == version
                              and not produced(src)):
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
            for t in _tensors(out):
                t.record_stream(here)
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
                _produced.update((id(t), t) for t in _tensors(self.out))
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
        dtypes): the graph's output buffers, or where the capture failed
        the first call's own output."""
        self._load(inputs)
        first = self.graph is None
        if first:
            out = self._capture()
            if self.graph is None:
                return out
        with span(self.name), torch.cuda.device(self.device):
            self.graph.replay()
        if not first:        # the first call counted its op-by-op run
            profiling.add_counts(self.launches)
            GRAPHS["replay"] += 1
        return self.out

    def release(self):
        """Forget this graph's output buffers as graph outputs: nothing
        replays into them any more."""
        if self.graph is not None:
            for t in _tensors(self.out):
                _produced.pop(id(t), None)


def _tensors(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def lookup(key, build, name, shared=()):
    """The :class:`StageGraph` of ``key`` (hashable: everything the
    stage's Python reads), made from ``build()`` = ``(fn, example)`` at the
    key's first use, taking the example's tensors at the positions
    ``shared`` as its static buffers, its replays in the span ``name``;
    None for a key whose capture failed."""
    graph = _graphs.get(key)
    if graph is None:
        graph = StageGraph(*build(), name, shared)
        _graphs[key] = graph
        if len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)[1].release()
    else:
        _graphs.move_to_end(key)
    return None if graph.failed else graph


def specs(tensors):
    """Each tensor's device, dtype and shape: the part of a stage's key
    that its inputs give."""
    return tuple((t.device, t.dtype, t.shape) for t in tensors)


def run(name, fn, tensors, key, share=()):
    """The stage ``fn(*tensors)``: where :func:`engaged`, replayed from the
    graph of ``(name, key)`` and the inputs' :func:`specs`, in the span
    ``<name>.replay``; else, or for a key whose capture failed, op by op.
    ``key`` holds everything else that ``fn``'s Python reads. An input at a
    position in ``share`` that is another graph's output buffer is that
    graph's static buffer (its identity joins the key). ``GRAPHS`` counts
    either way."""
    graph = None
    if engaged(tensors[0].device):
        adopt = tuple(i for i in share if produced(tensors[i]))
        graph = lookup((name, key, specs(tensors),
                        tuple((i, id(tensors[i])) for i in adopt)),
                       lambda: (fn, tensors), name + ".replay", adopt)
    if graph is None:
        GRAPHS["eager"] += 1
        return fn(*tensors)
    return graph(tensors)


def own(t):
    """``t``, or a copy of it where it is a graph's output buffer: what
    leaves the loop owns its memory."""
    return t.clone() if isinstance(t, torch.Tensor) and produced(t) else t


def clear():
    """Drop every kept graph, and with it every key's capture or failure."""
    _graphs.clear()
    _produced.clear()
