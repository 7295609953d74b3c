"""A tiny cell for the harness's tests on the CPU: the benchmark's files
copied to a temporary root, with a 96x96 configuration and small mixes
added as new files and new entries, nothing existing edited."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent


def bench_json():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def tiny_root(tmp: Path):
    """``(root, bench)``: a copy of ``gpet_bench/`` under ``tmp`` with the
    configuration ``tiny``, the mixes ``tiny_single`` and ``tiny_batch``,
    the cells ``tiny.single`` and ``tiny.batch`` (demo500.single's limits)
    and ``BENCHMARK.json``'s entries for them."""
    root = tmp / "gpet_bench"
    shutil.copytree(BENCH_DIR, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    conf = json.loads((root / "configs/demo500.json").read_text())
    conf["image"].update(size=[96, 96], amplitude=30)
    conf["tracer"]["kernel_options"].update(sigma_f=12, length_scale=6)
    conf["tracer"]["N_samples"] = 300
    (root / "configs/tiny.json").write_text(json.dumps(conf))
    single = json.loads((root / "traffic/single32.json").read_text())
    single.update(pool=3, check={"requests": 2, "frames": 1},
                  profile_requests=1)
    (root / "traffic/tiny_single.json").write_text(json.dumps(single))
    batch = json.loads((root / "traffic/batch64x2.json").read_text())
    batch.update(pool=8, batch=4, check={"requests": 1, "frames": 4})
    (root / "traffic/tiny_batch.json").write_text(json.dumps(batch))
    bench = copy.deepcopy(bench_json())
    for name, mix in (("tiny.single", "tiny_single"),
                      ("tiny.batch", "tiny_batch")):
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "t"})
        shutil.copy(root / "limits/demo500.single.json",
                    root / f"limits/{name}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("trace_ms_p95", "construct_ms"):
            m["workloads"].append("tiny.single")
        if m["name"] == "ms_per_frame_iter":
            m["workloads"].append("tiny.batch")
    return root, bench
