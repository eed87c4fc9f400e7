"""The port's spans (utils/timing.py `span`, `Timer`): off, a shared no-op
context; under torch.profiler, the frontend step's stages as FUNCTION-scope
ranges `sp/...`, nested as the step runs them, on the profiler's clock.
On the CPU at a small size (96x128, K=128)."""

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sp_orb_slam_tpu_torch.config import load_config
from sp_orb_slam_tpu_torch.extractor import make_extractor
from sp_orb_slam_tpu_torch.models.superpoint import init_params
from sp_orb_slam_tpu_torch.ops import cuda_match
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
from sp_orb_slam_tpu_torch.utils import timing

torch.set_num_threads(2)

H, W, NF, K = 96, 128, 100, 128
B = 2

# each span of the frontend step and the span that holds it
PARENT = {
    "sp/extract": None,
    "sp/extract/upload": "sp/extract",
    "sp/extract/forward": "sp/extract",
    "sp/extract/nms": "sp/extract",
    "sp/extract/select": "sp/extract",
    "sp/extract/desc": "sp/extract",
    "sp/extract/cov": "sp/extract",
    "sp/match/init": None,
    "sp/readback": None,
    "sp/readback/pack": "sp/readback",
    "sp/readback/copy": "sp/readback",
    "sp/readback/unpack": "sp/readback",
}


def host_spans(prof) -> list:
    """[(name, start_ns, end_ns, scope, is_user_annotation)] of the
    profiler's `sp/` events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.scope(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(timing.PREFIX)]


@pytest.fixture(scope="module")
def step_spans():
    """One frontend step under the profiler: extract (from a host
    array), init match, packed readback."""
    cfg = load_config(overrides={
        "camera": {"width": W, "height": H, "fx": 60.0, "fy": 60.0,
                   "cx": W / 2, "cy": H / 2},
        "tracking": {"num_features": NF},
        "runtime": {"max_keypoints": K}})
    run = make_extractor(cfg, init_params(torch.Generator().manual_seed(3)),
                         device="cpu")
    kernels = TrackingKernels(cfg, device="cpu")
    images = np.random.default_rng(2).random((B, H, W), np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feats = run(images)
        cuda_match.match_init_batch(feats.desc, feats.valid, feats.uv,
                                    feats.desc, feats.uv, feats.valid)
        host = kernels.fetch_features_host_batch(feats, B)
    assert len(host) == B and host[0]["uv"].shape == (K, 2)
    return host_spans(prof)


def test_span_off_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert timing.span("extract") is timing.span("readback/copy")
    with timing.span("extract") as x:
        assert x is None


def test_step_records_each_span_once(step_spans):
    names = [s[0] for s in step_spans]
    assert sorted(names) == sorted(PARENT)


def test_spans_nest_on_the_profilers_clock(step_spans):
    at = {name: (t0, t1) for name, t0, t1, _, _ in step_spans}
    for name, parent in PARENT.items():
        t0, t1 = at[name]
        assert t0 <= t1
        if parent is not None:
            p0, p1 = at[parent]
            assert p0 <= t0 and t1 <= p1, (name, parent)
    # the step's three calls in turn, and each parent's children in order
    order = ["sp/extract", "sp/match/init", "sp/readback"]
    assert [at[n][0] for n in order] == sorted(at[n][0] for n in order)
    for kids in (["sp/extract/upload", "sp/extract/forward",
                  "sp/extract/nms", "sp/extract/select", "sp/extract/desc",
                  "sp/extract/cov"],
                 ["sp/readback/pack", "sp/readback/copy",
                  "sp/readback/unpack"]):
        ends = [at[k][1] for k in kids[:-1]]
        starts = [at[k][0] for k in kids[1:]]
        assert all(e <= s for e, s in zip(ends, starts)), kids


def test_spans_are_not_user_annotations(step_spans):
    """A FUNCTION-scope range (scope 0): the profiler mirrors only user
    annotations (record_function) onto the device's timeline."""
    for name, _, _, scope, user in step_spans:
        assert scope == 0 and not user, name


def test_timer_span_reaches_the_profiler():
    t = timing.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("tracking/frame"):
            with t.span("tracking/total"):
                pass
    names = sorted(s[0] for s in host_spans(prof))
    assert names == ["sp/tracking/frame", "sp/tracking/total"]
    assert t.tags["tracking/frame"].count == 1
    with t.span("tracking/frame"):  # off: the host-clock sample alone
        pass
    assert len(t.samples()["tracking/frame"]) == 2


def test_timer_keeps_every_sample_and_the_rolling_table():
    t = timing.Timer()
    values = [(i % 7 + 1) * 1e-3 * (1 + i / 200) for i in range(180)]
    for v in values:
        t.add("tracking/total", v)
    assert t.samples()["tracking/total"] == values
    a = t.tags["tracking/total"]
    newest = values[-50:]
    assert a.mean == pytest.approx(statistics.mean(newest), rel=1e-12)
    assert a.std == pytest.approx(statistics.stdev(newest), rel=1e-12)
    assert a.count == 180 and a.total == pytest.approx(sum(values))
    row = t.table().splitlines()[1].split()
    assert row[:3] == ["total", f"{sum(values):.2f}", "180"]
    assert row[3:6] == [f"{statistics.mean(newest) * 1e3:.2f}", "+-",
                        f"{statistics.stdev(newest) * 1e3:.2f}"]


def test_timer_keeps_the_newest_samples_up_to_its_cap():
    a = timing._Accumulator(window=3, cap=5)
    for v in range(1, 9):
        a.add(float(v))
    assert list(a.samples) == [4.0, 5.0, 6.0, 7.0, 8.0]
    assert a.mean == 7.0 and a.count == 8 and a.min == 1.0 and a.max == 8.0
