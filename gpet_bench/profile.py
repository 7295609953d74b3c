"""The traced run's device timeline: ``torch.profiler`` around a short tail
of requests, read back from its Chrome trace.

``record(fn)`` runs ``fn`` under the profiler (host and device activity),
writes the trace into ``$TMPDIR``, reads it and deletes it, and returns a
:class:`Timeline`: every device operation (kernels, copies, sets) with its
start and duration, the host's operators, and the harness's own spans.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
_INNER = re.compile(r"(\w+_kernel\w*|\w+_impl|\w*Functor_\w+)\b")


def short_name(name: str) -> str:
    """A device operation's name without its template arguments and
    parameters, with the first inner kernel or functor name that PyTorch's
    generic kernels carry in brackets: ``at::native::elementwise_kernel
    [where_kernel_impl]``."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    cut = min([i for i in (head.find("<"), head.find("(")) if i > 0]
              or [len(head)])
    base = head[:cut]
    inner = [m for m in _INNER.findall(head[cut:])
             if m not in base and not m.startswith("gpu_kernel")
             and "elementwise" not in m]
    return f"{base}[{inner[0]}]" if inner else base


class Timeline(NamedTuple):
    device: list     # [(name, cat, start_us, dur_us)]
    host: list       # [(name, start_us, dur_us)] operators and spans
    t0_us: float     # the profiled window, on the trace's clock
    t1_us: float

    @property
    def window_s(self):
        return (self.t1_us - self.t0_us) / 1e6

    def kernels(self):
        return [d for d in self.device if d[1] == "kernel"]

    def busy_intervals(self):
        """The union of device activity inside the window, merged."""
        iv = sorted((max(s, self.t0_us), min(s + d, self.t1_us))
                    for _, _, s, d in self.device)
        merged = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time,
        by :func:`short_name`."""
        tot = {}
        for name, _, _, d in self.device:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top=10):
        """[[host activity, seconds]] of the longest idle gaps of the
        device: each gap named by the innermost host operator or span that
        covers its middle."""
        busy = self.busy_intervals()
        edges = [self.t0_us] + [x for ab in busy for x in ab] + [self.t1_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            cover = [h for h in self.host if h[1] <= mid <= h[1] + h[2]]
            name = min(cover, key=lambda h: h[2])[0] if cover else ""
            if name in ("", WINDOW):
                name = "host: Python between operators"
            out.append([name, (b - a) / 1e6])
        return out


def record(fn) -> Timeline:
    """``fn()`` under ``torch.profiler``; the device is synchronised before
    and after, and the window is the host's span around ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json",
                                dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    device, host = [], []
    t0 = t1 = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, cat, s, d))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((name, s, d))
            if name == WINDOW and cat == "user_annotation":
                t0, t1 = s, s + d
    if t0 is None:
        raise RuntimeError(f"the profiler's trace has no {WINDOW} span")
    return Timeline(device, host, t0, t1)

