"""One run of one cell: inputs from the seed, a warm-up request, a closed
loop of one client for the window, an optional profiled tail, the check
against the reference, and the result's line.

Everything that belongs to one configuration, traffic mix, metric or cell
is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(record)`` that returns a number, or None
where it finds nothing to read) and ``limits/<cell>.json``; the cells and
metrics are ``BENCHMARK.json``'s entries. The program is imported only
here, by its package name, and only once the run has a card.

The traffic's ``entry`` names the program's entry point that a request
drives: ``single`` is ``GP_Edge_Tracing(...)()`` on one image, from the
constructor to the integer trace and its interval on the host; ``batch``
is ``parallel.trace_batch`` over ``batch`` distinct images, from
``make_config``/``make_batch_data``/``make_batch_state`` to every frame's
trace and interval on the host.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gpet_bench import check, inputs, profile, reference

HERE = Path(__file__).resolve().parent
PROGRAM = "gaussian_process_edge_trace_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_process_edge_trace_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load(kind: str, name: str, root: Path = HERE):
    return json.loads((root / kind / f"{name}.json").read_text())


def reader(name: str, root: Path = HERE):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpet_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A cell of ``BENCHMARK.json`` with its files and its metrics."""

    def __init__(self, bench: dict, name: str, root: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.conf = load("configs", self.entry["config"], root)
        self.traffic = load("traffic", self.entry["traffic"], root)
        self.limits = load("limits", name, root)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]


class Pool:
    """The cell's images, made from the run's seed on ``device``."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        grads, self.truths = [], []
        for i in range(int(traffic["pool"])):
            g, edge = inputs.make_image(conf, inputs.derive(seed, "image", i),
                                        device)
            grads.append(g)
            self.truths.append(edge)
        self.grads = torch.stack(grads)
        ends = traffic["endpoints"]
        edge = self.truths[0]
        self.init = edge[[ends["left"], ends["right"]]][:, [1, 0]]
        self.E = int(self.init[1, 0] - self.init[0, 0]) + 1
        self.size = tuple(conf["image"]["size"])


class Request:
    """One request's record: its wall, its frames' iterations and, where
    it was kept for the check, its results."""

    def __init__(self, index, images, tseed, wall, construct, n_iters,
                 iter_nobs, result, edges, creds):
        self.index, self.images, self.tseed = index, images, tseed
        self.wall, self.construct = wall, construct
        self.n_iters, self.iter_nobs = n_iters, iter_nobs
        self.result, self.edges, self.creds = result, edges, creds

    def frames(self):
        return len(self.images)


class Client:
    """Drives the program's entry point as the traffic's ``entry`` says."""

    def __init__(self, gpt, cell: Cell, pool: Pool, device):
        self.gpt, self.pool, self.device = gpt, pool, device
        self.tr = cell.conf["tracer"]
        self.entry = cell.traffic["entry"]
        if self.entry not in ("single", "batch"):
            raise SystemExit(f"unknown entry {self.entry!r}")
        self.B = int(cell.traffic.get("batch", 1))

    def images_of(self, j):
        P = self.pool.grads.shape[0]
        return [(j * self.B + f) % P for f in range(self.B)]

    def request(self, j, tseed, timed_construct=False,
                spans=False) -> Request:
        """Request ``j`` with tracer seed ``tseed``. ``timed_construct``
        times the constructor, ending in a synchronise; ``spans`` marks the
        calls into the program for the profiler."""
        tr, pool = self.tr, self.pool
        images = self.images_of(j)
        construct = None
        span = (torch.profiler.record_function if spans
                else lambda _: contextlib.nullcontext())
        t0 = time.perf_counter()
        if self.entry == "single":
            with span("request: GP_Edge_Tracing.__init__"):
                tracer = self.gpt.GP_Edge_Tracing(
                    pool.init, pool.grads[images[0]], tr["kernel_options"],
                    tr["noise_y"], np.array([]), tr["N_samples"],
                    tr["score_thresh"], tr["delta_x"], tr["keep_ratio"],
                    tr["pixel_thresh"], tseed, True, tr["fix_endpoints"],
                    device=self.device)
            if timed_construct:
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize(self.device)
                construct = time.perf_counter() - t0
            with span("request: GP_Edge_Tracing.__call__"):
                edge, cred = tracer()
            wall = time.perf_counter() - t0
            res = tracer.last_result
            return Request(j, images, tseed, wall, construct, [res.n_iters],
                           res.iter_nobs[None], res, edge[None],
                           np.stack(cred)[None])
        from gaussian_process_edge_trace_torch.parallel import (
            make_batch_data, make_batch_state, trace_batch)
        from gaussian_process_edge_trace_torch.trace.driver import (
            make_config)
        with span("request: make_config, make_batch_data/state"):
            cfg = make_config(
                pool.init, pool.size, kernel_options=tr["kernel_options"],
                noise_y=tr["noise_y"], n_user_obs=0,
                N_samples=tr["N_samples"], score_thresh=tr["score_thresh"],
                delta_x=tr["delta_x"], keep_ratio=tr["keep_ratio"],
                pixel_thresh=tr["pixel_thresh"], seed=tseed,
                fix_endpoints=tr["fix_endpoints"])
            idx = torch.tensor(images, device=pool.grads.device)
            data = make_batch_data(cfg, pool.grads[idx],
                                   np.repeat(pool.init[None], self.B, 0),
                                   device=self.device)
            states = make_batch_state(cfg, self.B, device=self.device)
        with span("request: trace_batch"):
            res = trace_batch(cfg, data, states)
        with span("request: results to the host"):
            edges = res.edge_trace.cpu().numpy()
            creds = res.cred_interval.cpu().numpy()
        wall = time.perf_counter() - t0
        return Request(j, images, tseed, wall, None,
                       [int(v) for v in res.n_iters], res.iter_nobs, res,
                       edges, creds)


def _frame(res, f):
    """Frame ``f`` of a batched result, as one trace's."""
    from gaussian_process_edge_trace_torch.trace.driver import frame_of
    return frame_of(res, f)


def _sizes(cell: Cell, pool: Pool) -> dict:
    plan = reference.make_plan(pool.init, pool.size, cell.conf["tracer"])
    return {"E": plan.E, "M": plan.M, "N": plan.N, "S": plan.S,
            "N_keep": plan.N_keep, "n_inits": 2, "n_train": plan.n_train,
            "r": int(reference.prior_factor(plan).shape[1])}


def _host_record(reqs):
    """The requests' walls and iterations, on the host."""
    out = []
    for r in reqs:
        nobs = r.iter_nobs.cpu().numpy().reshape(len(r.n_iters), -1)
        out.append({"wall_s": r.wall, "construct_s": r.construct,
                    "n_iters": list(r.n_iters),
                    "iter_nobs": [row.tolist() for row in nobs]})
    return out


def run_check(cell: Cell, pool: Pool, kept: list, seed: int, log) -> dict:
    """The check's numbers over the kept traces: ``kept`` is a list of
    ``(request, frame)``."""
    per = []
    refs = {}
    for req, f in kept:
        img = req.images[f]
        res = req.result if req.frames() == 1 else _frame(req.result, f)
        out = check.from_result(res, req.edges[f], req.creds[f])
        if img not in refs:
            refs = {img: reference.Reference(pool.grads[img], pool.init,
                                             cell.conf["tracer"])}
        nums = check.compare(refs[img], out, req.tseed)
        log(f"check request {req.index} frame {f} image {img} "
            f"seed {req.tseed} n_iters {out.n_iters}: "
            + " ".join(f"{k} {v:.6g}" for k, v in nums.items()))
        per.append(nums)
    return check.combine(per)


def _keep_for_check(sample, longest, traffic, rng):
    """The kept traces, as ``(request, frame)``: of each sampled request
    ``check.frames`` frames drawn from the seed (every frame, where that is
    the batch), and the longest frame (most iterations) of the longest
    request."""
    want = int(traffic["check"].get("frames", 1))
    kept = {}
    for r in sample:
        nf = r.frames()
        for f in rng.sample(range(nf), min(want, nf)):
            kept[r.index, f] = r
    top = max(range(longest.frames()), key=lambda f: longest.n_iters[f])
    kept[longest.index, top] = longest
    return [(kept[k], k[1]) for k in sorted(kept)]


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = HERE, log=None) -> dict:
    """One run of ``workload``; returns the result's line as a dict."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(bench, workload, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib
    gpt = importlib.import_module(PROGRAM)
    pool = Pool(cell.conf, cell.traffic, seed, device)
    client = Client(gpt, cell, pool, device)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    client.request(0, inputs.derive(seed, "warmup"))
    sync()
    # What set-up made stays alive all run: keep it out of the collector's
    # passes inside the window.
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s")

    want = int(cell.traffic["check"]["requests"])
    rng = random.Random(inputs.derive(seed, "check"))
    sample, longest = [], None
    reqs, j = [], 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while not reqs or time.perf_counter() < deadline:
        r = client.request(j, inputs.derive(seed, "tracer", j),
                           timed_construct=trace)
        reqs.append(r)
        # The check's sample, drawn from the seed as the window runs (a
        # reservoir of ``want`` requests) and the longest request: only
        # their results stay on the device.
        out = [r]
        if j < want:
            sample.append(r)
        elif (m := rng.randint(0, j)) < want:
            out.append(sample[m])
            sample[m] = r
        if longest is None or max(r.n_iters) > max(longest.n_iters):
            out.append(longest)
            longest = r
        for x in out:
            if x is not None and x is not longest and x not in sample:
                x.result = None
        j += 1
    window_s = time.perf_counter() - t_start
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: "
                         f"{found}")
    n_it = [n for r in reqs for n in r.n_iters]
    walls = sorted(r.wall for r in reqs)
    log(f"window {window_s:.3f} s, {len(reqs)} requests, {len(n_it)} "
        f"traces, mean n_iters {sum(n_it) / len(n_it):.4f}, median "
        f"request {1e3 * walls[len(walls) // 2]:.3f} ms")

    kept = _keep_for_check(sample, longest, cell.traffic, rng)
    window = _host_record(reqs)
    dice = [v for r in reqs for f in range(r.frames())
            for v in inputs.dice_many(r.edges[f:f + 1],
                                      pool.truths[r.images[f]][:pool.E])]
    finite = [bool(np.isfinite(r.edges[f]).all()
                   and np.isfinite(r.creds[f]).all()
                   and r.edges[f].shape == (pool.E, 2))
              for r in reqs for f in range(r.frames())]
    record = {"entry": client.entry, "setup_s": setup_s,
              "window_s": window_s, "requests": window, "dice": dice,
              "sizes": _sizes(cell, pool)}

    timeline = None
    if trace:
        n_prof = int(cell.traffic["profile_requests"])
        prof = []

        def tail():
            for k in range(n_prof):
                prof.append(client.request(
                    j + k, inputs.derive(seed, "profile", k), spans=True))
        timeline = profile.record(tail)
        record["profile"] = {"timeline": timeline,
                             "requests": _host_record(prof)}
        del prof

    numbers = run_check(cell, pool, kept, seed, log)
    correct = check.judge(numbers, cell.limits) and all(finite)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"], root)(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(finite),
            "failed": int(sum(not f for f in finite)), "metrics": metrics,
            "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s()
        dev["window_s"] = timeline.window_s
        line["breakdown"] = {"device_ops": timeline.device_ops(),
                             "idle_gaps": timeline.idle_gaps()}
    line["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                     for k in check.NUMBERS}
    for k in check.NUMBERS:
        log(f"check {k} {numbers[k]!r} limit {cell.limits[k]!r}")
    return line


def print_line(line: dict):
    """The result's line: ``inf``/NaN numbers as strings, so that the line
    stays JSON."""
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, list):
            return [clean(x) for x in v]
        return v
    print(json.dumps(clean(line)), flush=True)
