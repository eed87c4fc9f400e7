"""Each count file against a hand count at small shapes, and the
forward's 61.22 GFLOP a frame at 752x480."""

import json
import os

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import ROOT


def count(name):
    return harness.load_module(ROOT, "counts", name)


def config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sp-euroc-f32.json")) as f:
        return json.load(f)


def test_superpoint_flops_per_frame():
    got = count("superpoint").flops_per_frame(config())
    assert got == pytest.approx(61.22e9, abs=0.005e9)
    small = dict(config(), camera=dict(width=16, height=8))
    # conv1a + conv1b at 16x8, conv2 pair at 8x4, conv3 pair at 4x2, the
    # rest at 2x1
    want = 2 * (128 * (1 * 64 * 9 + 64 * 64 * 9) + 32 * 2 * 64 * 64 * 9
                + 8 * (64 * 128 * 9 + 128 * 128 * 9)
                + 2 * (2 * 128 * 128 * 9 + 2 * 128 * 256 * 9 + 256 * 65
                       + 256 * 256))
    assert count("superpoint").flops_per_frame(small) == want


def test_conv1_pair():
    c = count("conv1_pair").count(dict(B=2, H=8, W=16), config())
    assert c["flops"] == 2 * 2 * 8 * 16 * 64 * (9 + 576)
    assert c["bytes"] == (2 * 8 * 16 * 4 + (576 + 64 + 36864 + 64) * 4
                          + 2 * 4 * 8 * 64 * 2)
    assert c["peak"] == "bf16_dense"


def test_nms():
    c = count("nms").count(dict(B=3, H=16, W=24), config())
    assert c == dict(flops=0.0, bytes=3 * 2 * 3 * 14, peak="fp32")


def test_cov_window_union():
    cov = count("cov")
    # two 5x5 windows overlapping in a 2x5 band, one clipped at the
    # corner, one invalid slot
    uv = np.array([[[4, 4], [4, 7], [0, 0], [9, 9]]], np.float32)
    valid = np.array([[True, True, True, False]])
    # windows (radius 2) start at (2,2), (2,5) and (0,0) clipped
    want = np.zeros((12, 12), bool)
    want[2:7, 2:7] = want[5:10, 2:7] = want[0:5, 0:5] = True
    assert cov.window_union(uv, valid, 12, 12, 2) == want.sum()
    c = cov.count(dict(B=1, K=4, H=12, W=12, uv=uv, valid=valid),
                  dict(cov_window=2))
    assert c["bytes"] == want.sum() * 4 + 4 * 29


def test_desc_sample_rows():
    d = count("desc_sample")
    # 64x32 image: an 8x4 cell map; two keypoints sharing corner rows
    uv = np.array([[[0, 0], [9, 0], [60, 30]]], np.float32)
    valid = np.array([[True, True, False]])
    # gx = floor(u * 7 / 64): 0 and 0 -> the same four rows
    assert d.corner_rows(uv, valid, 32, 64) == 4
    c = d.count(dict(B=1, K=3, H=32, W=64, uv=uv, valid=valid,
                     raw_desc_bytes=2), config())
    assert c["bytes"] == 4 * 256 * 2 + 3 * 9 + 3 * 256 * 4
    assert c["flops"] == 2 * 256 * 19


def test_init_match_pairs_against_brute_force():
    m = count("init_match")
    rng = np.random.default_rng(5)
    H, W, K = 60, 90, 40
    uv1 = rng.integers(0, [W, H], (2, K, 2)).astype(np.float32)
    uv2 = rng.integers(0, [W, H], (2, K, 2)).astype(np.float32)
    v1 = rng.random((2, K)) > 0.2
    v2 = rng.random((2, K)) > 0.2
    d = np.abs(uv1[:, :, None] - uv2[:, None, :])
    brute = int(((d[..., 0] < 13) & (d[..., 1] < 13) & v1[:, :, None]
                 & v2[:, None, :]).sum())
    assert m.pairs_in_window(uv1, v1, uv2, v2, 13, H, W) == brute
    c = m.count(dict(B=2, K=K, H=H, W=W, uv=uv2, valid=v2, prev_uv=uv1,
                     prev_valid=v1), dict(match=dict(window=13)))
    assert c["flops"] == 2 * 256 * brute
    assert c["bytes"] == ((v1.sum() + v2.sum()) * 1024 + 2 * 2 * K * 9
                          + 2 * K * 8 + 8)
