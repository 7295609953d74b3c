"""The check's two readings for a cell, on the card: the program's numbers
and the control's, on the same requests of each seed.

    python3 -m gpet_bench.control --workload <cell> --seeds <n> [<n> ...] \
        [--control-seeds <k>]

For each seed it builds the cell's pool as a run does, drives the first
``check.requests`` requests of the traffic through the program (no
window: a trace's result does not depend on the load), and compares the
same traces as a run compares them, once with the program's results and
once with the control in the program's place: the reference computed at
TF32 (``reference.Reference(tf32=True)``), the step below the float32
that the configurations state; ``--control-seeds k`` runs the control on
the first ``k`` seeds only. It prints one JSON line per seed and side
and, last, the largest and smallest reading of each number on each side. The
benchmark's own runs do not run it; ``limits/<cell>.json`` are set from
its readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gpet_bench import check, harness, inputs, reference


def readings(cell, seed, device="cuda", log=None, with_control=True):
    """``{"program": numbers, "control": numbers}`` of one seed (no
    ``"control"`` without ``with_control``)."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    gpt = importlib.import_module(harness.PROGRAM)
    pool = harness.Pool(cell.conf, cell.traffic, seed, device)
    client = harness.Client(gpt, cell, pool, device)
    want = cell.traffic["check"]
    reqs = [client.request(j, inputs.derive(seed, "tracer", j))
            for j in range(int(want["requests"]))]
    frames = int(want.get("frames", 1))
    kept = [(r, f) for r in reqs for f in range(min(frames, r.frames()))]
    got = {"program": harness.run_check(cell, pool, kept, seed, log)}
    if not with_control:
        return got
    per = []
    for r, f in kept:
        img = r.images[f]
        ref = reference.Reference(pool.grads[img], pool.init,
                                  cell.conf["tracer"])
        ctl = check.control_output(
            reference.Reference(pool.grads[img], pool.init,
                                cell.conf["tracer"], tf32=True), r.tseed)
        nums = check.compare(ref, ctl, r.tseed)
        log(f"control request {r.index} frame {f}: " + " ".join(
            f"{k} {v:.6g}" for k, v in nums.items()))
        per.append(nums)
    got["control"] = check.combine(per)
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    args = ap.parse_args(argv)
    bench = json.loads((Path.cwd() / "BENCHMARK.json").read_text())
    if not torch.cuda.is_available():
        sys.exit("the control runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(bench, args.workload)
    hi, lo = {}, {}
    n_ctl = len(args.seeds) if args.control_seeds is None else \
        args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        got = readings(cell, seed, with_control=i < n_ctl)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        for side, nums in got.items():
            print(json.dumps({"seed": seed, "side": side, **nums}),
                  flush=True)
            for k, v in nums.items():
                hi.setdefault(side, {})[k] = max(
                    hi.get(side, {}).get(k, -np.inf), v)
                lo.setdefault(side, {})[k] = min(
                    lo.get(side, {}).get(k, np.inf), v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "largest": hi, "smallest": lo}))


if __name__ == "__main__":
    main()
