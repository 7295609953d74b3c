"""Run one cell of the benchmark once, on the card.

    python3 -m gpet_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It reads ``BENCHMARK.json`` there, builds the
program's kernels into ``build/gpet_torch_kernels/`` of the checkout (or
``$GPET_TORCH_BUILD_DIR``), warms up, measures for ``--seconds``, checks
the traces against the plain reference and prints one JSON line as the
last line of its standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``. It exits with a
code other than 0, and prints no result, where there is no card or fewer
than the cell asks for, where the program is missing, or where a module of
JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.exit(f"no workload {args.workload!r} in BENCHMARK.json")
    os.environ.setdefault("GPET_TORCH_BUILD_DIR",
                          str(root / "build" / "gpet_torch_kernels"))

    import torch
    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.exit(f"this run needs {need} CUDA device(s); "
                 f"torch.cuda.is_available() is "
                 f"{torch.cuda.is_available()}, device_count() is "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    from gpet_bench import harness
    line = harness.run(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"modules of JAX or the JAX package loaded: {found}")
    harness.print_line(line)


if __name__ == "__main__":
    main()
