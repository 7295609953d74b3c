"""The harness on the CPU at a tiny size: cells, mixes and metrics found by
name, a cell added from new files only, the result line's keys, and the
check failing on a program broken underneath and on the control."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from gpet_bench import check, control, harness, profile, reference
from gpet_bench.tests.tiny import BENCH_DIR, bench_json, tiny_root

SEED = 2 ** 31 + 977


def _run(root, bench, cell, **kw):
    torch.manual_seed(0)
    return harness.run(bench, cell, SEED, 0.5, False, device="cpu",
                       root=root, log=lambda m: None, **kw)


def _digests(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_finds_its_files():
    bench = bench_json()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.conf["tracer"] and cell.traffic["entry"]
        assert set(cell.limits) == set(check.NUMBERS)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
    for c in bench["configs"]:
        assert (BENCH_DIR.parent / c["file"]).is_file()


def _no_profiler(fn):
    """The profiled tail without a card: the requests run, no device
    operation is seen."""
    fn()
    return profile.Timeline([], [], 0.0, 1.0)


def test_a_cell_from_new_files_only(tmp_path, monkeypatch):
    monkeypatch.setattr(profile, "record", _no_profiler)
    root, bench = tiny_root(tmp_path)
    before = _digests(root)
    # A new per-layer metric: a new reader file and a new entry.
    (root / "metrics/frames_per_request.py").write_text(
        "def read(record):\n"
        "    return sum(len(r['n_iters']) for r in record['requests'])"
        " / len(record['requests'])\n")
    bench["per_layer"].append({
        "name": "frames_per_request", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "Serving",
        "moves": "traces_per_s", "workloads": ["tiny.batch"]})
    line = harness.run(bench, "tiny.batch", SEED, 0.5, True, device="cpu",
                       root=root, log=lambda m: None)
    assert line["metrics"]["frames_per_request"]["value"] == 4
    line = _run(root, bench, "tiny.single")
    assert line["correct"] is True
    assert {"traces_per_s", "trace_ms_p95", "dice_median",
            "setup_s"} == set(line["metrics"])
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


def test_result_line_keys(tmp_path):
    root, bench = tiny_root(tmp_path)
    line = _run(root, bench, "tiny.batch")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 4 == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "trace_ms_p95" not in line["metrics"]
    for k in check.NUMBERS:
        assert set(line["check"][k]) == {"value", "limit"}
    json.dumps(line)


def _fault_state_unchanged(monkeypatch):
    from gaussian_process_edge_trace_torch.trace import driver
    monkeypatch.setattr(driver, "_iteration",
                        lambda cfg, data, state, z, w, **kw: (state, None))


def _fault_half_samples(monkeypatch):
    from gaussian_process_edge_trace_torch.trace import driver
    real = driver.curve_costs

    def half(*a, **kw):
        out = real(*a, **kw)
        costs = out[0] if isinstance(out, tuple) else out
        costs[..., costs.shape[-1] // 2:] = torch.inf
        return out
    monkeypatch.setattr(driver, "curve_costs", half)


def _fault_answer_altered(monkeypatch):
    from gaussian_process_edge_trace_torch.models import tracer
    from gaussian_process_edge_trace_torch.parallel import sharded
    from gaussian_process_edge_trace_torch.trace import driver
    real = driver.run_trace

    def altered(*a, **kw):
        res = real(*a, **kw)
        res.edge_trace[..., 7, 0] += 1
        return res
    for mod in (driver, tracer, sharded):
        monkeypatch.setattr(mod, "run_trace", altered)


def _fault_fit_at_its_start(monkeypatch):
    """The final fit's LML search returns its first start, θ0."""
    from gaussian_process_edge_trace_torch.trace import driver

    def first_start(kernel, xs, ys, mask, noise_w, starts, lb, ub, **kw):
        lead = xs.shape[:-1]
        theta = starts.expand(lead + starts.shape[-2:])[..., 0, :]
        return theta, torch.zeros(lead, device=xs.device)
    monkeypatch.setattr(driver, "optimize_lml", first_start)


def _fault_half_batch(monkeypatch):
    import gaussian_process_edge_trace_torch.parallel as par
    from gaussian_process_edge_trace_torch.trace.driver import (
        TraceResult, TracerData, TraceState)
    real = par.trace_batch
    framed = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")

    def half(cfg, data, states, draws=None):
        h = states.obs_x.shape[0] // 2
        d = TracerData(**{k: (v[:h] if k in framed else v)
                          for k, v in data._asdict().items()})
        s = TraceState(*(v[:h] for v in states))
        res = real(cfg, d, s, draws)
        return TraceResult(*(torch.cat([v, v]) for v in res))
    monkeypatch.setattr(par, "trace_batch", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.single", _fault_state_unchanged),
    ("tiny.single", _fault_half_samples),
    ("tiny.single", _fault_answer_altered),
    ("tiny.single", _fault_fit_at_its_start),
    ("tiny.batch", _fault_state_unchanged),
    ("tiny.batch", _fault_half_batch),
    ("tiny.batch", _fault_answer_altered),
    ("tiny.batch", _fault_fit_at_its_start),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    root, bench = tiny_root(tmp_path)
    fault(monkeypatch)
    assert _run(root, bench, cell)["correct"] is False


def test_the_control_is_not_correct_where_the_program_is(tmp_path):
    """The control, the reference at TF32 in the program's place, at the
    demo's shape on the CPU: the program's traces pass demo500.single's
    limits and the control's fail them."""
    bench = bench_json()
    cell = harness.Cell(bench, "demo500.single")
    cell.traffic = dict(cell.traffic, pool=1,
                        check={"requests": 1, "frames": 1})
    got = control.readings(cell, SEED, device="cpu", log=lambda m: None)
    assert check.judge(got["program"], cell.limits)
    assert not check.judge(got["control"], cell.limits)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.3e38,
                      float("inf"), float("nan")])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert torch.isinf(r[4]) and torch.isnan(r[5])
    m = r[:4].view(torch.int32) & 0x1FFF
    assert (m == 0).all()
    assert np.isfinite(float(r[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["demo500.single", "suite1000.oddE"])
def test_the_control_on_the_card(cell_name):
    """The same on the card, at the cell's own shape, two traces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "false")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.Cell(bench_json(), cell_name)
    cell.traffic = dict(cell.traffic, check={"requests": 2, "frames": 1})
    got = control.readings(cell, SEED, device="cuda", log=lambda m: None)
    assert check.judge(got["program"], cell.limits)
    assert not check.judge(got["control"], cell.limits)
