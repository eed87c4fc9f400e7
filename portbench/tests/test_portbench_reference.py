"""The plain reference against the port's plain path on the CPU at a tiny
size, float32: the same maps, keypoints, descriptors, covariances and
matches.  The two run the convolutions in different memory layouts
(channels-last against NCHW), whose sums round apart by about 1e-5 of a
logit: the tolerances leave that room and no more."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import checkpoint, reference, traffic
from portbench.reference import matching
from portbench.tests.conftest import ROOT, TINY_CAMERA


def test_reference_agrees_with_the_ports_plain_path():
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.ops.matching import init_match

    from portbench import harness

    fs = harness.load_module(ROOT, "drivers", "frontend_step")
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sp-euroc-f32.json")) as f:
        cfg = dict(json.load(f), camera=TINY_CAMERA)
    state = checkpoint.load(ROOT, cfg["weights"])
    t = dict(json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                         "b8-closed.json"))),
             streams=2, frames=2)
    frames = traffic.batches(traffic.render_all(TINY_CAMERA, t, 77,
                                                workers=0))
    run = make_extractor(fs.port_config(cfg),
                         {k: torch.from_numpy(v) for k, v in state.items()},
                         device="cpu")
    w = reference.weights_on(state, "cpu")
    feats, refs = [], []
    for x in frames:
        got = run(x)
        want = reference.extract(torch.from_numpy(x), w, cfg)
        assert torch.equal(got.valid, want["valid"])
        assert torch.equal(got.uv, want["uv"])
        assert torch.equal(got.occ_grid.long(), want["occ_grid"])
        torch.testing.assert_close(got.score, want["score"], rtol=1e-4,
                                   atol=1e-6)
        torch.testing.assert_close(got.semi_dust, want["maps"].semi_dust,
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.desc, want["desc"], rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(got.cov2, want["cov2"], rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(got.response, want["response"], rtol=0,
                                   atol=1e-5)
        assert int(got.count.min()) > 20
        feats.append(got)
    a, b = feats
    m = cfg["match"]
    port, _, _ = init_match(a.desc, a.valid, a.uv, b.desc, b.uv, b.valid,
                            window=m["window"], ratio=m["ratio"])
    mine = matching.match(a.desc, a.valid, a.uv, b.desc, b.uv, b.valid,
                          window=m["window"], ratio=m["ratio"],
                          th=m["th_low"])
    assert torch.equal(port.long(), mine)
    assert int((mine >= 0).sum()) > 10
    assert np.isfinite(b.desc.numpy()).all()


def test_match_margins():
    g = torch.Generator().manual_seed(3)
    d1 = torch.nn.functional.normalize(torch.randn(2, 60, 256, generator=g),
                                       dim=-1)
    d2 = torch.nn.functional.normalize(
        d1[:, torch.randperm(60, generator=g)]
        + 0.01 * torch.randn(2, 60, 256, generator=g), dim=-1)
    uv1 = torch.rand(2, 60, 2, generator=g) * 300
    uv2 = uv1[:, :].clone()
    v = torch.ones(2, 60, dtype=torch.bool)
    kw = dict(window=1000.0, ratio=0.9, th=0.3)
    dec = matching.decide(d1, v, uv1, d2, uv2, v, **kw)
    assert int((dec.match12 >= 0).sum()) > 100
    margin = dict(ratio=0.9, th=0.3, out_of_window=2.0)
    assert float(matching.margins(dec, dec.match12, **margin).max()) == 0.0
    # another column: its distance above the nearest
    bad = dec.match12.clone()
    i = int(torch.nonzero(bad[0] >= 0)[0, 0])
    bad[0, i] = (bad[0, i] + 1) % 60
    m = matching.margins(dec, bad, **margin)
    assert float(m[0, i]) > 0.5 and float(m.sum()) == float(m[0, i])
    # no match where the reference keeps one: the least slack
    none = dec.match12.clone()
    none[0, i] = -1
    m = matching.margins(dec, none, **margin)
    slack = min(0.3 - dec.best[0, i], 0.9 * dec.second[0, i]
                - dec.best[0, i])
    assert float(m[0, i]) == pytest.approx(float(slack))
    # a row past the window or on an invalid slot
    far = matching.decide(d1, v, uv1, d2, uv2 + 500, v,
                          **dict(kw, window=100.0))
    assert float(matching.margins(far, dec.match12, **margin).max()) == 2.0
