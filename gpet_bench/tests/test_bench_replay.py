"""The reader of the loop's replayed share, ``loop_replay_pct``, on
hand-made timelines: the replay spans of the scoring, KDE and selection
stages inside ``gpet.iter`` over those stages there, and None where no
replay span exists (a program without these graphs) or there is no
profile."""

from __future__ import annotations

import pytest

from gpet_bench import harness, profile


def _record(host):
    tl = profile.Timeline([], list(host), 0.0, 1000.0)
    return {"entry": "single",
            "profile": {"timeline": tl, "requests": [{"n_iters": [2]}]}}


# Two iterations, each with its three stages; a scoring stage outside them.
LOOP = [("gpet.iter", 0.0, 100.0), ("gpet.score", 10.0, 10.0),
        ("gpet.kde", 20.0, 10.0), ("gpet.select", 30.0, 10.0),
        ("gpet.iter", 200.0, 100.0), ("gpet.score", 210.0, 10.0),
        ("gpet.kde", 220.0, 10.0), ("gpet.select", 230.0, 10.0),
        ("gpet.score", 500.0, 10.0)]


def test_no_replay_span_reads_none():
    read = harness.reader("loop_replay_pct")
    assert read(_record(LOOP)) is None
    assert read({"entry": "single", "profile": None}) is None
    # The sampling stage's replays are another metric's.
    assert read(_record(LOOP + [("gpet.sample.replay", 5.0, 1.0)])) is None


@pytest.mark.parametrize("replayed,want", [
    ((("gpet.score.replay", 11.0),), 100.0 / 6),
    ((("gpet.score.replay", 11.0), ("gpet.kde.replay", 21.0),
      ("gpet.select.replay", 31.0)), 50.0),
    ((("gpet.score.replay", 11.0), ("gpet.kde.replay", 21.0),
      ("gpet.select.replay", 31.0), ("gpet.score.replay", 211.0),
      ("gpet.kde.replay", 221.0), ("gpet.select.replay", 231.0)), 100.0),
])
def test_replays_over_stages_in_the_loop(replayed, want):
    """Replays counted inside ``gpet.iter`` only: one outside the loop adds
    nothing."""
    host = LOOP + [(n, t, 2.0) for n, t in replayed]
    host.append(("gpet.score.replay", 501.0, 2.0))
    got = harness.reader("loop_replay_pct")(_record(host))
    assert got == pytest.approx(want)
