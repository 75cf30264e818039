"""The card's idle time inside the program's stage spans
(``harness/spans.py``), the split of a traced window by stage and the
Bezier compaction's tally (``tools/stage_idle.py``), and that tool's traced
run of the tiny render cell on the CPU, with the program's spans and tally
and without them."""

import contextlib

import pytest

from benchmark.harness import spans
from benchmark.tools import stage_idle

from .conftest import SEED, tiny_cell

#: Two passes over 0-200 us.  Device work 20-40 and 30-50 (merged 20-50),
#: 120-130 and 190-210 (cut at the window's end): idle 0-20, 50-120 and
#: 130-190, 150 us.  The spans, with the idle time inside each by hand:
#: rt3.eye -10-30 (starts before the window): 0-20, 20 us; rt3.walk 40-80
#: and 60-100 (overlapping) and 150-160: 50-100 and 150-160, 60 us; rt3.fold
#: 100-125: 100-120, 20 us; rt3.prepare 125-135: 130-135, 5 us;
#: rt3.estimate 185-230 (ends after the window): 185-190, 5 us.
RECORDS = [
    ("bench.pass", "cpu", 0, 100), ("bench.pass", "cpu", 100, 200),
    ("k1", "device", 20, 40), ("k2", "device", 30, 50), ("k3", "device", 120, 130),
    ("Memcpy DtoD (Device -> Device)", "device", 190, 210),
    ("cudaLaunchKernel", "runtime", 10, 12), ("aten::mul", "cpu", 5, 60),
    ("rt3.eye", "cpu", -10, 30),
    ("rt3.walk", "cpu", 40, 80), ("rt3.walk", "cpu", 60, 100), ("rt3.walk", "cpu", 150, 160),
    ("rt3.fold", "cpu", 100, 125), ("rt3.prepare", "cpu", 125, 135),
    ("rt3.estimate", "cpu", 185, 230),
]
IDLE_US = {"rt3.eye": 20, "rt3.walk": 60, "rt3.fold": 20, "rt3.prepare": 5, "rt3.estimate": 5}
#: Two passes' counters: 6 + 0 rays overflowed, 30 + 10 of 120 + 40 lanes used.
STATS = [{"bezier_overflow": 6, "bezier_lanes_used": 30, "bezier_lanes": 120},
         {"bezier_overflow": 0, "bezier_lanes_used": 10, "bezier_lanes": 40}]
#: The window's numbers by hand: 50 us busy of 200 (20-50, 120-130, 190-200),
#: one launch in two passes, and the spans' idle time above over 200 us.
NUMBERS = {"idle_share": 75.0, "launch_calls_per_pass": 0.5, "walk_idle_share": 30.0,
           "eye_idle_share": 10.0, "fold_idle_share": 15.0, "bezier_overflow_per_pass": 3.0,
           "bezier_lane_use": 25.0}
TALLY = ("bezier_overflow_per_pass", "bezier_lane_use")


def test_idle_inside_spans_by_hand():
    got = spans.idle_in_spans(RECORDS)
    assert set(got) == set(IDLE_US)
    for name, us in IDLE_US.items():
        assert got[name] == pytest.approx(us * 1e-6), name
    assert sum(got.values()) <= 150e-6


@pytest.mark.parametrize("records", [
    [r for r in RECORDS if not r[0].startswith("rt3.")],
    [r for r in RECORDS if r[0] != "bench.pass"],
], ids=["no-program-spans", "no-window"])
def test_idle_inside_spans_without_spans_or_window(records):
    assert spans.idle_in_spans(records) == {}


def test_a_span_over_a_busy_card_is_not_idle():
    recs = [("bench.pass", "cpu", 0, 100), ("k", "device", 0, 100), ("rt3.walk", "cpu", 10, 90)]
    assert spans.idle_in_spans(recs) == {"rt3.walk": 0.0}


def test_stage_numbers_by_hand():
    got = stage_idle.numbers(RECORDS, STATS)
    assert set(got) == set(NUMBERS)
    for k, want in NUMBERS.items():
        assert got[k] == pytest.approx(want), k
    assert sum(got[k] for k in stage_idle.STAGES) <= got["idle_share"]


@pytest.mark.parametrize("case", ["no-spans", "no-prepare-span", "no-counters", "no-lanes"])
def test_stage_numbers_leave_out_what_is_missing(case):
    records, stats = RECORDS, STATS
    if case == "no-spans":
        records = [r for r in RECORDS if not r[0].startswith("rt3.")]
        gone = set(stage_idle.STAGES)
    elif case == "no-prepare-span":
        records = [r for r in RECORDS if r[0] != "rt3.prepare"]
        gone = {"fold_idle_share"}
    elif case == "no-counters":
        stats = [{}, dict(STATS[1])]
        gone = set(TALLY)
    else:
        stats = [dict(st, bezier_lanes=0, bezier_lanes_used=0) for st in STATS]
        gone = {"bezier_lane_use"}
    assert set(stage_idle.numbers(records, stats)) == set(NUMBERS) - gone


@pytest.mark.parametrize("program", ["with-spans", "without"])
def test_the_tool_splits_a_traced_run(program, monkeypatch):
    """The tiny cell's traced pass on the CPU (no device events, so the whole
    window reads idle).  ``without``: the program's spans and tally taken
    out, as in a program that predates them; their numbers are then left
    out and nothing raises."""
    from raytrace3_tpu_torch.render import sppm
    from raytrace3_tpu_torch.utils import trace

    if program == "without":
        monkeypatch.setattr(sppm, "span", lambda name: contextlib.nullcontext())
        monkeypatch.setattr(trace.BezierTally, "fold", lambda self, device: {})
    c, _ = tiny_cell()
    real = c.pass_fn
    records, stats = stage_idle.traced(c, SEED, 1)
    assert c.pass_fn is real and len(stats) == 1
    got = stage_idle.numbers(records, stats)
    base = {"idle_share", "launch_calls_per_pass"}
    if program == "without":
        assert set(got) == base
        return
    assert set(got) == set(NUMBERS)
    assert set(spans.idle_in_spans(records)) == set(IDLE_US)
    assert 0 < sum(got[k] for k in stage_idle.STAGES) <= got["idle_share"] + 1e-9
    assert got["bezier_overflow_per_pass"] == 0 and 0 < got["bezier_lane_use"] <= 100
