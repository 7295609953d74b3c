"""The readers of the program's ``gpet.*`` spans on a hand-made timeline:
each metric against its value worked by hand, and None where the profile
holds none of the spans (a program without them) or where there is no
profile."""

from __future__ import annotations

import pytest

from gpet_bench import harness, profile

SPAN_METRICS = ("sample_ms_per_iter", "score_ms_per_iter", "kde_ms_per_iter",
                "select_ms_per_iter", "loop_idle_pct", "finish_ms",
                "host_waits_per_request", "host_wait_pct",
                "per_frame_ms_per_iter")


def _record(host, device=(), requests=2):
    """A traced run's record: a window of 1000 µs, ``requests`` profiled
    requests."""
    tl = profile.Timeline(list(device), list(host), 0.0, 1000.0)
    return {"entry": "single",
            "profile": {"timeline": tl,
                        "requests": [{"n_iters": [1]}] * requests}}


# Two iterations, [100, 300) and [400, 600) µs, with their stages; a
# sampling span and a per-frame span outside them that no reader counts;
# two final fits; four waits; the operators around them.
HOST = [
    ("bench.window", 0.0, 1000.0), ("aten::mm", 120.0, 5.0),
    ("gpet.iter", 100.0, 200.0), ("gpet.iter", 400.0, 200.0),
    ("gpet.sample", 100.0, 50.0), ("gpet.score", 150.0, 60.0),
    ("gpet.kde", 210.0, 40.0), ("gpet.select", 250.0, 40.0),
    ("gpet.sample", 400.0, 30.0), ("gpet.score", 430.0, 70.0),
    ("gpet.kde", 500.0, 50.0), ("gpet.select", 550.0, 40.0),
    ("gpet.sample", 700.0, 100.0),
    ("gpet.frame_by_frame", 160.0, 20.0), ("gpet.frame_by_frame", 440.0, 30.0),
    ("gpet.frame_by_frame", 660.0, 10.0),
    ("gpet.finish", 650.0, 100.0), ("gpet.finish", 800.0, 50.0),
    ("gpet.wait.active", 280.0, 20.0), ("gpet.wait.active", 580.0, 20.0),
    ("gpet.wait.jitter", 120.0, 10.0), ("gpet.wait.result", 900.0, 30.0),
]
# Busy [150, 250), [280, 340), [500, 550) and [900, 1000) inside the window.
DEVICE = [("k", "kernel", 150.0, 100.0), ("k", "kernel", 280.0, 60.0),
          ("copy", "gpu_memcpy", 500.0, 50.0), ("k", "kernel", 900.0, 200.0)]


def test_span_metrics_on_a_hand_made_timeline():
    rec = _record(HOST, DEVICE)
    got = {m: harness.reader(m)(rec) for m in SPAN_METRICS}
    want = {
        "sample_ms_per_iter": (0.050 + 0.030) / 2,
        "score_ms_per_iter": (0.060 + 0.070) / 2,
        "kde_ms_per_iter": (0.040 + 0.050) / 2,
        "select_ms_per_iter": (0.040 + 0.040) / 2,
        # Inside the iterations the device is busy 100 + 20 + 50 of 400 µs.
        "loop_idle_pct": 100.0 * (1.0 - 170.0 / 400.0),
        "finish_ms": 0.150 / 2,
        "host_waits_per_request": 4 / 2,
        "host_wait_pct": 100.0 * 80.0 / 1000.0,
        "per_frame_ms_per_iter": (0.020 + 0.030) / 2,
    }
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("host", [
    [("bench.window", 0.0, 1000.0), ("aten::mm", 120.0, 5.0),
     ("request: GP_Edge_Tracing.__call__", 50.0, 900.0)],
    [],
], ids=["a program without spans", "nothing on the host"])
def test_span_metrics_read_none_without_their_spans(host):
    rec = _record(host, DEVICE)
    assert {m: harness.reader(m)(rec) for m in SPAN_METRICS} == \
        dict.fromkeys(SPAN_METRICS)


def test_span_metrics_read_none_without_a_profile():
    rec = {"entry": "single", "requests": []}
    assert {m: harness.reader(m)(rec) for m in SPAN_METRICS} == \
        dict.fromkeys(SPAN_METRICS)


def test_stages_without_iterations_read_none():
    """Stage and per-frame spans outside any ``gpet.iter`` (a program that
    steps its loop another way) are not counted."""
    host = [h for h in HOST if h[0] != "gpet.iter"]
    rec = _record(host, DEVICE)
    for m in ("sample_ms_per_iter", "score_ms_per_iter", "kde_ms_per_iter",
              "select_ms_per_iter", "loop_idle_pct",
              "per_frame_ms_per_iter"):
        assert harness.reader(m)(rec) is None, m
    assert harness.reader("finish_ms")(rec) == pytest.approx(0.075)


def test_every_span_metric_has_its_entry():
    from gpet_bench.tests.tiny import bench_json
    entries = {m["name"]: m for m in bench_json()["per_layer"]}
    for m in SPAN_METRICS:
        e = entries[m]
        assert e["source"] == "device_trace" and e["moves"] == "traces_per_s"
        assert e["workloads"]
