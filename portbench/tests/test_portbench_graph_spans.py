"""`graph_launches_per_step` on the hand-made trace of
test_portbench_spans.py (fixtures/profile_spans.json, two traced steps),
with each step's extraction replayed as a CUDA graph: one
`cudaGraphLaunch` inside `sp/extract/replay` a step, and one outside every
span that the reader leaves out."""

import json
import os

import pytest

from portbench import harness, spans
from portbench.tests.conftest import ROOT

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def rec():
    with open(os.path.join(HERE, "fixtures", "profile_spans.json")) as f:
        return json.load(f)


def read(rec):
    return harness.load_module(ROOT, "metrics",
                               "graph_launches_per_step").read(rec)


def replayed(rec):
    """Each step's forward (110-210 us of the step) as a replay: the span
    and its graph launch; a stray launch at 950 us, outside every span."""
    host = rec["profile"]["host"]
    for t0 in (0, 1_000_000):
        host += [["sp/extract/replay", t0 + 110_000, 100_000],
                 ["cudaGraphLaunch", t0 + 120_000, 20_000]]
    host.append(["cudaGraphLaunch", 950_000, 5_000])
    host.sort(key=lambda r: r[1])
    return rec


def test_one_graph_launch_a_step(rec):
    assert read(replayed(rec)) == 1


def test_eager_steps_read_zero(rec):
    assert read(rec) == 0


def test_replay_span_in_the_table(rec):
    t = spans.table(replayed(rec)["profile"])
    assert t["sp/extract/replay"] == pytest.approx(
        dict(ms=0.100, launches=2, syncs=0))


def test_silent_without_spans(rec):
    rec = replayed(rec)
    rec["profile"]["host"] = [r for r in rec["profile"]["host"]
                              if not r[0].startswith(spans.PREFIX)]
    assert read(rec) is None
    del rec["profile"]
    assert read(rec) is None
