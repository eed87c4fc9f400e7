"""The span readers on a hand-made trace (fixtures/profile_spans.json): two
traced steps, each with the program's nested `sp/` spans, two blocking
syncs inside them and one outside, and known device gaps."""

import json
import os

import pytest

from portbench import harness, spans, trace
from portbench.tests.conftest import ROOT

HERE = os.path.dirname(os.path.abspath(__file__))
READERS = ("program_enqueue_ms", "upload_ms", "upload_idle_ms",
           "readback_ms", "readback_idle_ms", "host_syncs_per_step")


@pytest.fixture
def rec():
    with open(os.path.join(HERE, "fixtures", "profile_spans.json")) as f:
        return json.load(f)


def read(rec, name):
    return harness.load_module(ROOT, "metrics", name).read(rec)


def test_span_metrics(rec):
    # a step: sp/extract 10-300 us, sp/match/init 310-350
    assert read(rec, "program_enqueue_ms") == pytest.approx(0.330)
    # sp/extract/upload 10-110 us; the HtoD copy keeps the device busy
    # 40-90
    assert read(rec, "upload_ms") == pytest.approx(0.100)
    assert read(rec, "upload_idle_ms") == pytest.approx(0.050)
    # sp/readback 510-710 us; the DtoH copy 600-630
    assert read(rec, "readback_ms") == pytest.approx(0.200)
    assert read(rec, "readback_idle_ms") == pytest.approx(0.170)
    # the upload's and the copy's stream syncs; the device sync at 900 us
    # lies outside every span
    assert read(rec, "host_syncs_per_step") == 2


def test_table_by_span(rec):
    t = spans.table(rec["profile"])
    assert sorted(t) == ["sp/extract", "sp/extract/forward",
                         "sp/extract/nms", "sp/extract/upload",
                         "sp/match/init", "sp/readback", "sp/readback/copy",
                         "sp/readback/pack", "sp/readback/unpack"]
    assert t["sp/extract"] == pytest.approx(
        dict(ms=0.290, launches=3, syncs=1))
    assert t["sp/extract/upload"] == pytest.approx(
        dict(ms=0.100, launches=0, syncs=1))
    assert t["sp/match/init"] == pytest.approx(
        dict(ms=0.040, launches=1, syncs=0))
    assert t["sp/readback"] == pytest.approx(
        dict(ms=0.200, launches=1, syncs=1))
    assert t["sp/readback/unpack"] == pytest.approx(
        dict(ms=0.050, launches=0, syncs=0))


def test_breakdown_names_a_program_span(rec):
    # the device idles 260-330 us of a step while the host is in
    # sp/extract after its NMS
    gaps = dict(trace.breakdown(rec["profile"])["idle_gaps"])
    assert gaps["hand_in: sp/extract"] == pytest.approx(2 * 70e-6)


@pytest.mark.parametrize("name", READERS)
def test_silent_without_spans(rec, name):
    rec["profile"]["host"] = [r for r in rec["profile"]["host"]
                              if not r[0].startswith(spans.PREFIX)]
    assert read(rec, name) is None
    del rec["profile"]
    assert read(rec, name) is None
