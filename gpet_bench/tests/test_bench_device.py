"""The loop's device-time readers on a hand-written Chrome trace, read
through ``profile.record``: a set-up kernel, two loop iterations whose
sampling and KDE kernels run on the device after their spans have closed,
each iteration closed by its read of the active mask, and a final fit with
a K6 kernel of its own. Each reader against its value worked by hand, and
None where the loop's reads are missing or there is no profile."""

from __future__ import annotations

import json

import pytest
import torch

from gpet_bench import harness, profile, work, work_k7k8
from gpet_bench.metrics import _device

NEW = ("elementwise_ms_per_iter", "K6_roofline", "K7_roofline",
       "K8_roofline")
EW = "void at::native::vectorized_elementwise_kernel<4, at::native::" \
     "CUDAFunctor_add<float>>(int, at::native::CUDAFunctor_add<float>)"
RED = "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)"
IDX = "void at::native::index_elementwise_kernel<128, 4>(long)"
K1 = "fused_cost_partial_kernel(float const*, float*, int)"
K3 = "binning_2l_kernel(float const*, float const*, float*, int)"
K5 = "batched_chol_kernel(float const*, float*, int)"
K6 = "batched_trsm_kernel(float const*, float const*, float*, int)"
K7 = "threefry_table_kernel(Table)"
K8 = "frames_product_kernel(float const*, float const*, float*, int)"
DTOH = "Memcpy DtoH (Device -> Pinned)"

# One iteration's device operations in the order the host launched them
# (name, category, µs): sampling, scoring, KDE, selection.
ITERATION = [(K7, "kernel", 10.0), (EW, "kernel", 20.0), (K5, "kernel", 4.0),
             (K6, "kernel", 30.0), (K6, "kernel", 30.0), (K8, "kernel", 40.0),
             (K1, "kernel", 15.0), (RED, "kernel", 5.0),
             (K3, "kernel", 8.0), (EW, "kernel", 12.0),
             (IDX, "kernel", 6.0), (DTOH, "gpu_memcpy", 2.0)]
FINISH = [(K5, "kernel", 20.0), (K6, "kernel", 50.0), (EW, "kernel", 7.0)]
SETUP = [(EW, "kernel", 9.0)]
# The host's spans (µs): each iteration's stages, then its read of the
# active mask; one read before the loop; the final fit.
HOST = {"gpet.run_trace": [(100.0, 1400.0)],
        "gpet.iter": [(110.0, 420.0), (430.0, 750.0)],
        "gpet.sample": [(112.0, 130.0), (432.0, 450.0)],
        "gpet.score": [(131.0, 140.0), (451.0, 460.0)],
        "gpet.kde": [(141.0, 200.0), (461.0, 520.0)],
        "gpet.select": [(201.0, 380.0), (521.0, 700.0)],
        "gpet.finish": [(760.0, 1390.0)],
        "gpet.wait.active": [(104.0, 108.0), (390.0, 410.0),
                             (710.0, 740.0)]}
# Where the device starts each group: the set-up's, each iteration's (40
# µs after its span opened, so sampling's kernels run after
# ``gpet.sample`` has closed, in the KDE's span or later), the final fit's.
DEVICE_AT = [(20.0, SETUP), (150.0, ITERATION), (470.0, ITERATION),
             (800.0, FINISH)]


def _events(drop_reads=()):
    """The Chrome trace's events: the window, the spans but the reads
    numbered in ``drop_reads``, the device's operations, and the launches
    (``cuda_runtime``) that ``profile.record`` leaves out."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW,
           "ts": 0.0, "dur": 2000.0}]
    for name, iv in HOST.items():
        for i, (a, b) in enumerate(iv):
            if name == _device.ACTIVE and i in drop_reads:
                continue
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": a, "dur": b - a})
    for t, ops in DEVICE_AT:
        for name, cat, dur in ops:
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": t,
                       "dur": dur, "args": {"stream": 7}})
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": 100.0, "dur": 3.0})
            t += dur + 2.0
    return ev


class _Profiler:
    """``torch.profiler.profile`` in ``profile.record``'s place: it
    exports the hand-written trace."""

    events = None

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.events}, fh)


SIZES = {"E": 50, "M": 700, "N": 700, "S": 1000, "N_keep": 100, "r": 6,
         "n_inits": 2, "n_train": 20}


def _record(monkeypatch, **kw):
    monkeypatch.setattr(_Profiler, "events", _events(**kw))
    monkeypatch.setattr(torch.profiler, "profile", _Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tl = profile.record(lambda: None)
    return {"entry": "single", "sizes": dict(SIZES),
            "profile": {"timeline": tl,
                        "requests": [{"n_iters": [2],
                                      "iter_nobs": [[3, 5]]}]}}


def _read(rec):
    return {m: harness.reader(m)(rec) for m in NEW}


def test_loop_readers_on_a_hand_written_trace(monkeypatch):
    rec = _record(monkeypatch)
    # The sampling and KDE stages' kernels ran after their spans closed.
    tl = rec["profile"]["timeline"]
    first = {k: min(s for n, _, s, _ in tl.kernels() if n == k)
             for k in (K6, K3)}
    assert first[K6] > HOST["gpet.sample"][0][1]
    assert first[K3] > HOST["gpet.kde"][0][1]
    got = _read(rec)
    S, E = SIZES["S"], SIZES["E"]

    def k6(n):      # work_k6(1, n, S): bytes-bound at these sizes
        return 4 * (n * (n + 1) // 2 + 2 * n * S) / 3.35e12

    def k8(n):      # (E, n) @ (n, S): bytes-bound at these sizes
        return 4 * (E * n + n * S + E * S) / 3.35e12
    want = {
        # The set-up's and the final fit's are not counted.
        "elementwise_ms_per_iter": (20 + 5 + 12 + 6) / 1e3,
        # Both solves at n = 2, then at n = 2 + 3; the final fit's K6
        # (50 µs) is not counted.
        "K6_roofline": 100 * 2 * (k6(2) + k6(5)) / 120e-6,
        "K7_roofline": 100 * 2 * work_k7k8.iteration_table_s(6, 20, S)
        / 20e-6,
        # No blur as a matmul at 702 x 702.
        "K8_roofline": 100 * (k8(2) + k8(5)) / 80e-6,
    }
    assert got == pytest.approx(want, rel=1e-12)
    assert work.bound(*work.work_k6(1, 5, S))[0] == pytest.approx(k6(5))
    assert work.bound(*work_k7k8.work_k8(1, E, S, 5))[0] == \
        pytest.approx(k8(5))


def test_loop_ops_are_what_the_iterations_launched(monkeypatch):
    """Each iteration's interval runs from the end of the read before it
    to the end of its own read, and holds that iteration's operations and
    no others: neither the set-up's nor the final fit's."""
    rec = _record(monkeypatch)
    assert _device.iteration_windows(rec) == [(108.0, 410.0),
                                              (410.0, 740.0)]
    ops, n = _device.loop_ops(rec)
    assert n == 2
    assert ops == [(name, cat, d) for name, cat, d in ITERATION] * 2
    assert _device.iter_ms(rec, lambda name, cat: True) == pytest.approx(
        sum(d for *_, d in ITERATION) / 1e3, rel=1e-12)


def test_blur_products_count_where_the_grid_blurs_as_matmuls(monkeypatch):
    rec = _record(monkeypatch)
    plain = harness.reader("K8_roofline")(rec)
    rec["sizes"].update(M=500, N=500)
    band = sum(work_k7k8.bound_k8(1, 502, 502, 502, band=8, **{s: True})
               for s in ("a_shared", "b_shared"))
    assert harness.reader("K8_roofline")(rec) == pytest.approx(
        plain + 100 * 2 * band / 80e-6, rel=1e-12)


@pytest.mark.parametrize("drop", [(0, 1, 2), (0,), (2,)],
                         ids=["no reads", "no read before the loop",
                              "an iteration without its read"])
def test_loop_readers_read_none_without_the_loop_reads(monkeypatch, drop):
    assert _read(_record(monkeypatch, drop_reads=drop)) == dict.fromkeys(NEW)


def test_loop_readers_read_none_without_a_profile():
    rec = {"entry": "single", "requests": [], "sizes": dict(SIZES)}
    assert _read(rec) == dict.fromkeys(NEW)


def test_frozen_bounds_against_the_kernel_table():
    """PERF.md's kernel table: K8's 1000² cross product 0.0621 ms, its
    banded blur of 64 demo frames 0.0388 ms (bytes), K7's S = 10⁵
    iteration table 0.0874 ms (the issue rate at 1,980 MHz)."""
    ms = 1e3 * work_k7k8.bound_k8(1, 1000, 10_000, 208)
    assert round(ms, 4) == 0.0621
    t, kind = work.bound(*work_k7k8.work_k8(64, 502, 502, 502,
                                            a_shared=True, band=8))
    assert (round(1e3 * t, 4), kind) == (0.0388, "bytes")
    t, kind = work_k7k8.bound_k7(*work_k7k8.work_threefry(256 * 100_000))
    assert (round(1e3 * t, 4), kind) == (0.0874, "issue")
    assert round(1e3 * work_k7k8.iteration_table_s(48, 208, 100_000), 4) \
        == 0.0874


def test_every_loop_metric_has_its_entry():
    from gpet_bench.tests.tiny import bench_json
    bench = bench_json()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in NEW:
        e = entries[m]
        assert e["source"] == "device_trace" and e["moves"] == "traces_per_s"
        assert e["workloads"] == cells
