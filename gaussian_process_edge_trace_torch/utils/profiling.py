"""Tracing and profiling utilities.

Port of ``gaussian_process_edge_trace_tpu/utils/profiling.py``. The
reference's only instrumentation is ``time.time()`` prints
(gpet.py:815,831-835,864-870,897-899). Here:

- :func:`span`: a named span of the program on ``torch.profiler``'s clock
  while a profiler records, and a shared do-nothing context otherwise;
- :func:`wait`: one wait of the host for the device, a span
  ``gpet.wait.<kind>`` and one count of ``kind`` in :data:`HOST_READS`;
- :func:`counters` / :func:`reset_counters` / :func:`add_counts`: every
  module counter of the package (kernel launches, blocked factorisations,
  the host's waits and the bytes they copy, collectives, the loop's stage
  graphs) as one flat snapshot, set to 0, or added to;
- :class:`PhaseTimer`: host wall-clock accumulated per named phase;
- :func:`device_trace`: ``torch.profiler`` around a block, written as a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``), the
  program's ``gpet.*`` spans over the device's kernels;
- :func:`trace_telemetry`: the per-iteration telemetry of a
  :class:`~..trace.driver.TraceResult` as a dict of numpy arrays;
- :func:`sync_timer`: the median device time of one call between CUDA
  events, after a warm-up, the card held busy while the host enqueues it,
  less that of an empty launch;
- :func:`device_op_breakdown`: device time per kernel name from
  ``torch.profiler``.

The spans, from the entry point down: ``gpet.construct``
(``GP_Edge_Tracing.__init__``), ``gpet.run_trace``, ``gpet.iter`` (one
iteration of ``run_loop``, its active-mask read included) holding the
stages ``gpet.sample``, ``gpet.score``, ``gpet.kde`` and ``gpet.select``
(each holding ``<stage>.replay`` where the stage replays its CUDA graph,
``trace/stage_graph.py``), ``gpet.finish`` (the final fit),
``gpet.frame_by_frame`` (the loop's frame-batched products, solve and sums
of a batch on the card, ``models/gpr.py::frames_span``) and
``gpet.wait.<kind>``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

# The host's waits for the device, by kind: each is one :class:`wait`
# around a read by ``trace/driver.py::to_host`` or a blocking copy to the
# device, and holds one host-device round trip, the first of a block
# draining the stream. They are counted by code path, so the CPU counts
# what the card waits for. ``active``: the loop's active mask, once before
# the first iteration and once after each; ``finish``: ``finish_trace``'s
# ``n_iters`` and ``converged``; ``state``/``samples``: the introspective
# tracer's reads of the state and of each iteration's curves; ``frame``: a
# batched state's iteration count as one trace's (``frame_of``; one trace's
# state, run as a batch of one, comes back at an iteration the host counted
# and waits for nothing on the way in or out); ``result``: the tracer's
# trace, interval and last threshold; ``data``: the constructor's
# copies (init points, prior factor) and its read of the x grid; ``init``:
# ``init_state``'s two scalars; ``consts``: the selection's tables, once a
# trace; ``fit``: the final fit's bounds and first start, its screen grid
# and its step sizes. HOST_BYTES counts, by kind, the bytes that
# ``to_host`` copies to the host.
HOST_READS = dict.fromkeys(
    ("active", "finish", "state", "samples", "frame", "result",
     "data", "init", "consts", "fit"), 0)
HOST_BYTES = dict.fromkeys(HOST_READS, 0)

# The loop's stages as CUDA graphs (``trace/stage_graph.py``), each stage
# call counted once: ``capture``: graphs captured (the call that captures
# replays too); ``replay``: stages replayed from one; ``eager``: stages run
# op by op (off the card, under a dispatch mode, the scoring stage under a
# sample axis, or where the capture failed); ``failed``: captures that
# raised, once a key.
GRAPHS = dict.fromkeys(("capture", "replay", "eager", "failed"), 0)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A span of the program named ``name``: while a ``torch.profiler``
    records, ``torch.profiler.record_function(name)`` (a
    ``user_annotation`` event on the profiler's clock, beside the kernels it
    launches); otherwise one shared do-nothing context, so a span costs
    one check when no profiler records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class wait:
    """One wait of the host for the device around the block (a read, or a
    blocking copy from pageable host memory, which drains the stream
    first): the span ``gpet.wait.<kind>`` and one count of ``kind`` in
    :data:`HOST_READS`. The package reaches it as ``profiling.wait``, so
    every such wait passes through this one class (a context manager, as
    ``contextlib.suppress`` is)."""

    __slots__ = ("kind", "_span")

    def __init__(self, kind: str):
        self.kind = kind
        self._span = None

    def __enter__(self):
        HOST_READS[self.kind] += 1
        if torch.autograd._profiler_enabled():
            self._span = torch.profiler.record_function(
                "gpet.wait." + self.kind)
            self._span.__enter__()

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)


def _counter_dicts():
    from gaussian_process_edge_trace_torch.ops import (
        collectives, cuda_chol, cuda_frames, cuda_interp, prng)
    from gaussian_process_edge_trace_torch.trace import cuda_kde
    return {"LAUNCHES": (cuda_interp.LAUNCHES, cuda_kde.LAUNCHES,
                         cuda_chol.LAUNCHES, prng.LAUNCHES,
                         cuda_frames.LAUNCHES),
            "BLOCKED": (cuda_chol.BLOCKED,),
            "HOST_READS": (HOST_READS,), "HOST_BYTES": (HOST_BYTES,),
            "COLLECTIVES": (collectives.COLLECTIVES,), "GRAPHS": (GRAPHS,)}


def counters() -> dict:
    """Every module counter of the package as one flat snapshot,
    ``{"<DICT>.<key>": n}``: the kernels' ``LAUNCHES`` (K1-K9), the blocked
    K5/K6 calls (``BLOCKED``), the host's waits (``HOST_READS``) and the
    bytes ``to_host`` copies (``HOST_BYTES``), the collectives
    (``COLLECTIVES``), the loop's stage graphs (``GRAPHS``)."""
    return {f"{name}.{k}": v for name, ds in _counter_dicts().items()
            for d in ds for k, v in d.items()}


def add_counts(delta: dict):
    """Add ``{"<DICT>.<key>": n}`` (keys of :func:`counters`) to the module
    counters, in place."""
    dicts = _counter_dicts()
    for name_key, n in delta.items():
        name, key = name_key.split(".", 1)
        for d in dicts[name]:
            if key in d:
                d[key] += n


def reset_counters():
    """Set every module counter to 0, in place: the dicts stay where they
    are, so a caller that holds one reads the new counts."""
    for ds in _counter_dicts().values():
        for d in ds:
            for k in d:
                d[k] = 0


class PhaseTimer:
    """Accumulate wall-clock per named phase; ``report()`` returns a dict."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir):
    """``torch.profiler`` around the block (host and, where there is a
    card, device activity); the trace is written to
    ``log_dir/trace.json`` in the Chrome trace format, the program's
    ``gpet.*`` spans (:func:`span`) over the kernels they launched, on one
    clock. Yields the profiler."""
    from pathlib import Path

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def trace_telemetry(result):
    """Per-iteration telemetry of one trace's TraceResult as numpy arrays
    (the JAX function's keys)."""
    n = int(result.n_iters)
    return {
        "n_iters": n,
        "converged": bool(result.converged),
        "optimal_costs": _numpy(result.iter_costs[:n]),
        "n_obs": _numpy(result.iter_nobs[:n]),
        "score_thresholds": _numpy(result.iter_thresh[:n]),
        "theta": np.exp(_numpy(result.theta)),
        "log_marginal_likelihood": float(result.lml),
        "final_cost": float(result.final_cost),
    }


# A spin of about a millisecond on the card (at ~2 GHz) ahead of each timed
# call: the card waits in it while the host enqueues the call.
_SPIN_CYCLES = 2_000_000


def sync_timer(fn, *args, n=10):
    """Median device time of ``fn(*args)`` in seconds, on the card.

    Each call runs between two CUDA events on the current stream, after
    one warm-up call, with a spin kernel of about a millisecond enqueued
    ahead of the first event: the card is busy while the host enqueues the
    events and the call's launches, so the interval is the card's time for
    them, not the host's (a call whose launches take the host longer than
    its kernels take the card would otherwise be timed by the host). The
    median over ``n`` calls has the median of an empty launch's time (a
    one-element add, timed the same way) subtracted, the counterpart of the
    JAX function's dispatch baseline. ``fn`` must launch its work on the
    current stream and must not synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("sync_timer needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    x = torch.ones(1, device="cuda")

    def med(f, *a):
        f(*a)
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            f(*a)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3)
        return sorted(ts)[len(ts) // 2]

    base = med(lambda v: v + 1.0, x)
    return max(med(fn, *args) - base, 0.0)


def _device_us(evt):
    """An event's own device time in µs, under either of the names the
    profiler has given it."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def device_op_breakdown(fn, *args, top=20, log_dir=None):
    """Device time per kernel name of one call to ``fn(*args)``, from
    ``torch.profiler`` after one warm-up call.

    Returns ``[(total_ms, name), ...]`` sorted by time, at most ``top``
    rows. Entry 0 is the kernel that took the most device time; there is no
    whole-program entry, as a trace is many launches and no one compiled
    program. On the card the rows are the device (CUDA) events of the
    trace: the port's kernels appear under their ``__global__`` names
    (demangled, with their namespace and arguments), K1
    ``fused_cost_partial_kernel`` and its chunk sum
    ``fused_cost_reduce_kernel``, K2 ``column_interp_tiled_kernel`` /
    ``column_interp_flat_kernel``, K3 ``binning_2l_kernel``, K4
    ``binning_dense_kernel``, K5 ``batched_chol_kernel`` and K6
    ``batched_trsv_kernel`` / ``batched_trsm_kernel``, beside PyTorch's own
    kernels. Without a card the rows are the CPU operators' self time
    (approximate: host frames). ``log_dir`` also keeps the Chrome trace
    there."""
    fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        from pathlib import Path
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    stats = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(_device_us(e) / 1e3, e.key) for e in stats
            if e.device_type == cuda and _device_us(e) > 0]
    if not rows:
        rows = [(e.self_cpu_time_total / 1e3, e.key) for e in stats
                if e.self_cpu_time_total > 0]
    rows.sort(reverse=True)
    return rows[:top]
