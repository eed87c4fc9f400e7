"""Port parity of the optimizers: pose_optimization, pose_optimization_post,
pose_optimization_dust and bundle_adjust of sp_orb_slam_tpu_torch against
the JAX package on seeded problems built from the synthetic scene, on the
CPU.

Tolerances: poses and points within 1e-4 (float32 LM with the same
iteration count and accept/reject sequence; the sums run in another
order).  Inlier masks are equal except near-ties: an edge whose chi2 lies
within 1e-3 relative of its gate may fall either side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config, _merge_dataclass
from sp_orb_slam_tpu.geometry import se3 as jse3
from sp_orb_slam_tpu.io.dataset import SyntheticDataset
from sp_orb_slam_tpu.optim import ba as jba
from sp_orb_slam_tpu.optim import pose as jpose
from sp_orb_slam_tpu_torch.optim import ba as tba
from sp_orb_slam_tpu_torch.optim import pose as tpose

torch.set_num_threads(2)

TOL = 1e-4
CFG = _merge_dataclass(Config(), {
    "dataset": "synthetic",
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "fps": 20.0},
    "runtime": {"max_keypoints": 256}})
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturb(T, rng, rot=0.01, trans=0.05):
    xi = np.concatenate([rng.normal(0, rot, 3),
                         rng.normal(0, trans, 3)]).astype(np.float32)
    return (np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ T).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(CFG, n_frames=12, n_points=3000, seed=4,
                            pixel_noise=0.3)


def _frame_problem(scene, i, rng, outlier_frac=0.15):
    raw = scene.frame(i)
    inj = raw.injected
    valid = inj["valid"].copy()
    Xw = np.zeros((len(valid), 3), np.float32)
    Xw[valid] = scene.points[inj["point_ids"][valid]]
    Xw[valid] += rng.normal(0, 0.01, Xw[valid].shape).astype(np.float32)
    obs = inj["uv"].copy()
    bad = valid & (rng.random(len(valid)) < outlier_frac)
    obs[bad] += rng.uniform(-30, 30, (bad.sum(), 2)).astype(np.float32)
    cov = rng.uniform(0.5, 1.5, (len(valid), 2)).astype(np.float32)
    Tgt = np.linalg.inv(raw.gt_pose).astype(np.float32)
    return raw, Tgt, Xw, obs, cov, valid


def _masks_equal(got, want, chi2, gate):
    diff = got != want
    near = np.abs(chi2 - gate) <= 1e-3 * gate
    assert not (diff & ~near).any(), np.nonzero(diff & ~near)


@pytest.mark.parametrize("i", [2, 7])
def test_pose_optimization(scene, i):
    rng = np.random.default_rng(i)
    _, Tgt, Xw, obs, cov, valid = _frame_problem(scene, i, rng)
    T0 = _perturb(Tgt, rng)
    want = jpose.pose_optimization(T0, Xw, obs, cov, valid, K)
    got = tpose.pose_optimization(_t(T0), _t(Xw), _t(obs), _t(cov),
                                  _t(valid), _t(K))
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw),
                               atol=TOL, rtol=0)
    _masks_equal(got.inlier.numpy(), np.asarray(want.inlier),
                 np.asarray(want.chi2), jpose.CHI2_MONO)
    assert abs(int(got.n_inlier) - int(want.n_inlier)) <= 1
    assert int(got.n_inlier) > 50


def test_pose_optimization_start_fan(scene):
    """A fan of starts (the relocalization multi-start) gives, start by
    start, the single-start result."""
    rng = np.random.default_rng(11)
    _, Tgt, Xw, obs, cov, valid = _frame_problem(scene, 5, rng)
    T0s = np.stack([_perturb(Tgt, rng) for _ in range(3)])
    fan = tpose.pose_optimization(_t(T0s), _t(Xw), _t(obs), _t(cov),
                                  _t(valid), _t(K))
    for s in range(3):
        one = jpose.pose_optimization(T0s[s], Xw, obs, cov, valid, K)
        np.testing.assert_allclose(fan.Tcw[s].numpy(), np.asarray(one.Tcw),
                                   atol=TOL, rtol=0)
        _masks_equal(fan.inlier[s].numpy(), np.asarray(one.inlier),
                     np.asarray(one.chi2), jpose.CHI2_MONO)


def test_pose_optimization_post(scene):
    rng = np.random.default_rng(3)
    _, Tgt, Xw, obs, cov, valid = _frame_problem(scene, 4, rng)
    T0 = _perturb(Tgt, rng, rot=0.005, trans=0.02)
    want = jpose.pose_optimization_post(T0, Xw, obs, cov, valid, K)
    got = tpose.pose_optimization_post(_t(T0), _t(Xw), _t(obs), _t(cov),
                                       _t(valid), _t(K))
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))


@pytest.mark.parametrize("i", [3, 9])
def test_pose_optimization_dust(scene, i):
    rng = np.random.default_rng(20 + i)
    raw, Tgt, Xw, _, _, valid = _frame_problem(scene, i, rng, 0.0)
    dust = raw.injected["dust"]
    T0 = _perturb(Tgt, rng, rot=0.004, trans=0.03)
    want = jpose.pose_optimization_dust(T0, Xw, valid, dust, K)
    got = tpose.pose_optimization_dust(_t(T0), _t(Xw), _t(valid), _t(dust),
                                       _t(K))
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.proj_uv.numpy(), np.asarray(want.proj_uv),
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(want.inlier))
    assert int(got.n_inlier) > 30


def _ba_problem(scene, rng, n_kf=5, n_pts=192, O=1024):
    C = 8
    kf_frames = [0, 2, 4, 6, 8][:n_kf]
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    fixed = np.ones(C, bool)
    Tgt = [np.linalg.inv(scene.poses[f]).astype(np.float32)
           for f in kf_frames]
    for c, T in enumerate(Tgt):
        poses[c] = T if c == 0 else _perturb(T, rng, 0.002, 0.01)
        fixed[c] = c == 0
    # points seen by several keyframes, perturbed
    vis = np.ones(len(scene.points), bool)
    for T in Tgt:
        pc = scene.points @ T[:3, :3].T + T[:3, 3]
        u = 260 * pc[:, 0] / pc[:, 2] + 160
        v = 260 * pc[:, 1] / pc[:, 2] + 120
        vis &= (pc[:, 2] > 0.5) & (u > 5) & (u < 315) & (v > 5) & (v < 235)
    ids = rng.choice(np.nonzero(vis)[0], n_pts, replace=False)
    P = 256
    points = np.zeros((P, 3), np.float32)
    pt_valid = np.zeros(P, bool)
    points[:n_pts] = scene.points[ids] + rng.normal(0, 0.02, (n_pts, 3))
    pt_valid[:n_pts] = True
    obs_cam = np.zeros(O, np.int32)
    obs_pt = np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 2), np.float32)
    obs_w = np.ones((O, 2), np.float32)
    obs_valid = np.zeros(O, bool)
    o = 0
    for c, T in enumerate(Tgt):
        pc = scene.points[ids] @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([260 * pc[:, 0] / pc[:, 2] + 160,
                       260 * pc[:, 1] / pc[:, 2] + 120], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        uv[rng.random(n_pts) < 0.05] += 25.0      # a few gross outliers
        obs_cam[o:o + n_pts] = c
        obs_pt[o:o + n_pts] = np.arange(n_pts)
        obs_uv[o:o + n_pts] = uv
        obs_w[o:o + n_pts] = rng.uniform(0.5, 1.5, (n_pts, 2))
        obs_valid[o:o + n_pts] = True
        o += n_pts
    return (poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv, obs_w,
            obs_valid)


@pytest.mark.parametrize("two_phase", [True, False])
def test_bundle_adjust(scene, two_phase):
    rng = np.random.default_rng(7)
    prob = _ba_problem(scene, rng)
    kw = dict(iters1=5, iters2=10, two_phase=two_phase, robust=True)
    want = jba.bundle_adjust(*prob, K, **kw)
    args = [_t(a) for a in prob]
    args[4], args[5] = args[4].long(), args[5].long()
    got = tba.bundle_adjust(*args, _t(K), **kw)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=TOL, rtol=0)
    _masks_equal(got.bad_obs.numpy(), np.asarray(want.bad_obs),
                 np.asarray(want.chi2), jba.CHI2_MONO)
    # the solve moved the free cameras toward the truth
    assert np.asarray(want.bad_obs).sum() > 10
