"""Tracing and profiling utilities.

Port of ``gaussian_process_edge_trace_tpu/utils/profiling.py``. The
reference's only instrumentation is ``time.time()`` prints
(gpet.py:815,831-835,864-870,897-899). Here:

- :class:`PhaseTimer`: host wall-clock accumulated per named phase;
- :func:`device_trace`: ``torch.profiler`` around a block, written as a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``);
- :func:`trace_telemetry`: the per-iteration telemetry of a
  :class:`~..trace.driver.TraceResult` as a dict of numpy arrays;
- :func:`sync_timer`: the median device time of one call between CUDA
  events, after a warm-up, the card held busy while the host enqueues it,
  less that of an empty launch;
- :func:`device_op_breakdown`: device time per kernel name from
  ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


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
    ``log_dir/trace.json`` in the Chrome trace format. Yields the
    profiler."""
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
