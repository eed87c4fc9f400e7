"""Each metric reader on a recorded record: two traced steps of known
device events (fixtures/profile_small.json), against hand sums."""

import json
import os

import numpy as np
import pytest

from portbench import harness, trace
from portbench.tests.conftest import ROOT

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def rec():
    with open(os.path.join(HERE, "fixtures", "profile_small.json")) as f:
        r = json.load(f)
    for x in r["profile"]["inputs"]:
        for k in ("uv", "valid", "prev_uv", "prev_valid"):
            x[k] = np.asarray(x[k])
    cfg = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                         "sp-euroc-bf16.json"))
    r.update(config=cfg, root=ROOT, functions=trace.functions(ROOT),
             peaks=harness.load_json(os.path.join(ROOT, "portbench",
                                                  "peaks.json")))
    return r


def read(rec, name):
    return harness.load_module(ROOT, "metrics", name).read(rec)


def test_host_clock_metrics(rec):
    assert read(rec, "frames_per_s") == 800.0
    assert read(rec, "latency_ms_p95") == pytest.approx(
        float(np.percentile([0.02] * 19 + [0.04], 95)) * 1e3)
    assert read(rec, "setup_s") == 12.5
    assert read(rec, "host_enqueue_ms") == pytest.approx(5.0)
    flops = harness.load_module(ROOT, "counts", "superpoint") \
        .flops_per_frame(rec["config"])
    assert read(rec, "step_mfu") == pytest.approx(
        100 * flops * 800.0 / 989e12)
    assert read(rec, "peak_mem_gib") == 2.0


def test_device_trace_metrics(rec):
    assert read(rec, "transfer_ms") == pytest.approx(0.035)
    assert read(rec, "conv_ms") == pytest.approx(0.150)
    assert read(rec, "other_kernels_ms") == pytest.approx(0.003)
    assert read(rec, "launches_per_step") == 12
    # busy a step: [0, 182] + [190, 246] + [250, 255] us of 300
    assert read(rec, "idle_share") == pytest.approx(
        100 * (1 - 2 * 243e-6 / 6e-4))


def test_rooflines(rec):
    hbm = 3.35e12
    nms = 1 * 2 * 3 * 14 / hbm
    assert read(rec, "nms_roofline") == pytest.approx(100 * nms / 10e-6)
    pair = max(2 * 16 * 24 * 64 * 585 / 989e12,
               (16 * 24 * 4 + 37568 * 4 + 8 * 12 * 64 * 2) / hbm)
    assert read(rec, "conv1_pair_roofline") == pytest.approx(
        100 * pair / 100e-6)
    match = harness.load_module(ROOT, "counts", "init_match").count(
        rec["profile"]["inputs"][0], rec["config"])
    bound = max(match["flops"] / 67e12, match["bytes"] / hbm)
    assert read(rec, "init_match_roofline") == pytest.approx(
        100 * bound / 20e-6)
    for name in ("cov_roofline", "desc_sample_roofline"):
        assert 0 < read(rec, name) < 100


def test_silent_without_kernels_or_trace(rec):
    rec["profile"]["device"] = [e for e in rec["profile"]["device"]
                                if "pair1" not in e[0]]
    assert read(rec, "conv1_pair_roofline") is None
    del rec["profile"]
    for name in ("transfer_ms", "conv_ms", "idle_share", "nms_roofline",
                 "launches_per_step"):
        assert read(rec, name) is None


def test_breakdown(rec):
    b = trace.breakdown(rec["profile"])
    assert b["device_ops"][0][0].startswith("void pair1_kernel")
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    # the innermost host event at each gap's middle, under its annotation
    assert gaps["hand_in: cudaLaunchKernel"] == pytest.approx(2 * 8e-6)
    assert gaps["collect: cudaMemcpyAsync"] == pytest.approx(2 * 4e-6)
    assert gaps["outside: python"] == pytest.approx(45e-6)
