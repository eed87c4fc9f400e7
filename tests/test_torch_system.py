"""The offline SLAM slice as a whole, on the CPU:

(a) the synthetic injected-feature rail (test_e2e_synthetic.py's small
    config, seed 6, 50 frames) through the JAX package's System and the
    port's System(device="cpu"), the port's tracker taking the JAX
    package's two-view RANSAC draws: both end OK with 0 LOST, the port's
    ATE is < 0.1 and within 0.02 of the JAX ATE, and its keyframe and
    point counts are within 15 % of the JAX run's;
(b) the rendered image rail on the port alone (trained weights, 376x240,
    the first 40 frames of the held-out room): it initializes, loses no
    frame and keeps >= 3 keyframes;
(c) the port's own copies of JAX-free modules (slam/map.py,
    slam/depth_filter.py, eval/ate.py, the synthetic dataset) hold equal to
    their originals on the same inputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.eval import ate as jate
from sp_orb_slam_tpu.io import dataset as jds
from sp_orb_slam_tpu.slam import depth_filter as jdf
from sp_orb_slam_tpu.slam import frame as jframe
from sp_orb_slam_tpu.slam import map as jmap
from sp_orb_slam_tpu.slam import tracking as jtr
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval import ate as tate
from sp_orb_slam_tpu_torch.io import dataset as tds
from sp_orb_slam_tpu_torch.slam import depth_filter as tdf
from sp_orb_slam_tpu_torch.slam import frame as tframe
from sp_orb_slam_tpu_torch.slam import map as tmap
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.system import System

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "sp_rendered.npz")
SMALL = {"dataset": "synthetic",
         "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                    "cx": 160.0, "cy": 120.0, "fps": 20.0},
         "tracking": {"num_features": 250},
         "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                     "local_points_cap": 1024, "ba_kfs_cap": 32,
                     "ba_points_cap": 1024, "ba_obs_cap": 4096,
                     "init_ransac_iters": 60}}


class JaxInitDraws:
    """The JAX package's init draws (tracking.py: PRNGKey(31415926), one
    split per attempt, randint over the match count)."""

    def __init__(self, iters):
        self.key = jax.random.PRNGKey(31415926)
        self.iters = iters

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.randint(sub, (self.iters, 8), 0,
                                           max(n, 1)))


def _ate(sys_, ds):
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    return tate.ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])


def test_synthetic_rail_matches_jax(tmp_path):
    jcfg, cfg = jmerge(JConfig(), SMALL), _merge_dataclass(Config(), SMALL)
    kw = dict(n_frames=50, n_points=5000, seed=6, pixel_noise=0.3)
    jsys = JSystem(jcfg)
    jsys.spin(jds.SyntheticDataset(jcfg, **kw))
    ds = tds.SyntheticDataset(cfg, **kw)
    tsys = System(cfg, device="cpu")
    tsys.tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)
    tsys.spin(ds)

    jrep, trep = jsys.report(), tsys.report()
    assert jsys.tracker.state == jtr.OK and jrep["n_lost"] == 0, jrep
    assert tsys.tracker.state == ttr.OK and trep["n_lost"] == 0, trep
    j_ate, t_ate = _ate(jsys, ds).rmse, _ate(tsys, ds).rmse
    assert t_ate < 0.1 and abs(t_ate - j_ate) < 0.02, (t_ate, j_ate)
    for k in ("n_keyframes", "n_points"):
        assert abs(trep[k] - jrep[k]) <= 0.15 * jrep[k], (k, trep, jrep)
    assert trep["n_frames"] == jrep["n_frames"]

    # the trajectory writers
    tsys.save_trajectory_tum(str(tmp_path / "traj.txt"))
    assert np.loadtxt(tmp_path / "traj.txt").shape == (trep["n_frames"], 8)
    tsys.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    assert len(np.loadtxt(tmp_path / "kf.txt")) == trep["n_keyframes"]
    tsys.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    assert np.loadtxt(tmp_path / "kitti.txt").shape[1] == 12
    tsys.save_trajectory_euroc(str(tmp_path / "euroc.txt"))
    assert len(open(tmp_path / "euroc.txt").readlines()) == trep["n_frames"]


@pytest.mark.skipif(not os.path.exists(WEIGHTS),
                    reason="trained checkpoint not present")
def test_rendered_rail_tracks():
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg = _merge_dataclass(Config(), {
        "camera": {"width": 376, "height": 240, "fx": 178.05, "fy": 209.0,
                   "cx": 181.38, "cy": 125.09}})
    ds = RenderedDataset(cfg, n_frames=220, seed=5, noise_seed=0)
    sys_ = System(cfg, params=load_checkpoint(WEIGHTS), device="cpu")
    sys_.spin(ds, max_frames=40)
    rep = sys_.report()
    assert sys_.tracker.state == ttr.OK, rep
    assert rep["n_frames"] >= 20 and rep["n_lost"] == 0, rep
    assert rep["n_keyframes"] >= 3, rep
    assert _ate(sys_, ds).rmse < 0.1


# ---------------------------------------------------------------- (c) copies


def _frames(mod, rng, n=4, K=32, jax_side=True):
    out = []
    for i in range(n):
        d = rng.normal(size=(K, 256)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * i, 0.0, 0.05 * i]
        dev = jnp.asarray if jax_side else torch.from_numpy
        f = mod.FrameData(
            frame_id=i, timestamp=0.05 * i,
            uv=rng.uniform(0, 300, (K, 2)).astype(np.float32),
            score=np.ones(K, np.float32), response=np.ones(K, np.float32),
            valid=np.ones(K, bool), cov2_inv=np.ones((K, 2), np.float32),
            occ_grid=np.zeros((4, 4), np.int32), count=K,
            desc_dev=dev(d), dust_dev=None, occ_grid_dev=None)
        f.set_pose(T)
        out.append(f)
    return out


def _drive_map(fmod, mmod, jax_side):
    """One scripted map history: keyframes, points with observations,
    descriptors, normals, covisibility, a replace, a KF erase, the bank."""
    rng = np.random.default_rng(0)
    world = mmod.Map(256)
    kfs = [world.add_keyframe(f)
           for f in _frames(fmod, rng, jax_side=jax_side)]
    for p in range(60):
        mp = world.create_point(rng.normal(0, 1, 3).astype(np.float32) +
                                [0, 0, 5], kfs[0].kf_id)
        for kf in kfs:
            if (p + kf.kf_id) % 3:
                world.add_observation(mp, kf.kf_id, p % 32)
        world.compute_distinctive_descriptor(mp)
        world.update_desc_track(mp, kfs[-1].kf_id, p % 32)
        world.update_normal_and_depth(mp)
    for kf in kfs:
        world.update_connections(kf)
    world.replace_point(world.points[3], world.points[4])
    world.erase_keyframe(kfs[2])
    for _ in range(6):
        world.advance_epoch()
    bank = np.array(world.pool.device_bank("desc"))
    return world, bank


def test_map_copy_matches_original():
    jw, jbank = _drive_map(jframe, jmap, True)
    tw, tbank = _drive_map(tframe, tmap, False)
    for name in ("pos", "desc", "desc_track", "normal", "min_dist",
                 "max_dist", "alive"):
        np.testing.assert_array_equal(getattr(tw.pool, name),
                                      getattr(jw.pool, name), err_msg=name)
    np.testing.assert_array_equal(tbank, jbank)
    assert sorted(tw.points) == sorted(jw.points)
    for pid, mp in jw.points.items():
        tp = tw.points[pid]
        assert (tp.obs, tp.bad, tp.replaced_by, tp.n_found, tp.n_visible) \
            == (mp.obs, mp.bad, mp.replaced_by, mp.n_found, mp.n_visible)
    for k, kf in jw.keyframes.items():
        tkf = tw.keyframes[k]
        assert (tkf.connections, tkf.ordered_neighbors, tkf.parent,
                tkf.children, tkf.bad) == (kf.connections,
                                           kf.ordered_neighbors, kf.parent,
                                           kf.children, kf.bad)
        np.testing.assert_array_equal(tkf.mp_ids, kf.mp_ids)
        np.testing.assert_array_equal(tkf.Tcw, kf.Tcw)
    assert (tw.n_keyframes(), tw.n_points()) == (jw.n_keyframes(),
                                                 jw.n_points())
    kf = tw.keyframes[0]
    assert tw.scene_median_depth(kf) == jw.scene_median_depth(
        jw.keyframes[0])
    assert tw.tracked_in_common(kf, {5, 6, 7}) == jw.tracked_in_common(
        jw.keyframes[0], {5, 6, 7})


def test_depth_filter_copy_matches_original():
    rng = np.random.default_rng(1)
    banks = [mod.SeedBank(64) for mod in (jdf, tdf)]
    idx = np.arange(0, 64, 2)
    z = rng.uniform(2, 8, idx.size).astype(np.float32)
    for _ in range(4):
        x = (1 / z + rng.normal(0, 0.01, idx.size)).astype(np.float32)
        tau2 = rng.uniform(1e-5, 1e-3, idx.size).astype(np.float32)
        for bk in banks:
            if not bk.active.any():
                bk.init_slots(idx, z, 1.5, 3)
            else:
                bk.update(idx, x, tau2)
    for name in ("active", "mu", "sigma2", "a", "b", "z_range", "born",
                 "n_upd"):
        np.testing.assert_array_equal(getattr(banks[1], name),
                                      getattr(banks[0], name), err_msg=name)
    np.testing.assert_array_equal(banks[1].converged(20.0, 0.05),
                                  banks[0].converged(20.0, 0.05))


def test_ate_and_dataset_copies_match_originals():
    rng = np.random.default_rng(2)
    t = np.arange(40) / 20.0
    p_gt = rng.normal(size=(40, 3))
    p_est = 2.0 * p_gt + rng.normal(0, 0.01, (40, 3)) + 1.0
    assert tate.ate_sim3(t, p_est, t, p_gt) == jate.ate_sim3(t, p_est, t,
                                                             p_gt)
    assert tate.umeyama_sim3(p_est, p_gt)[0] == jate.umeyama_sim3(
        p_est, p_gt)[0]
    jcfg, cfg = jmerge(JConfig(), SMALL), _merge_dataclass(Config(), SMALL)
    for kw in ({}, {"trajectory": "degenerate"}, {"loop": True}):
        jd = jds.SyntheticDataset(jcfg, n_frames=6, n_points=500, seed=3,
                                  **kw)
        td = tds.SyntheticDataset(cfg, n_frames=6, n_points=500, seed=3,
                                  **kw)
        np.testing.assert_array_equal(td.poses, jd.poses)
        for i in (0, 5):
            a, b = td.frame(i), jd.frame(i)
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.global_desc, b.global_desc)
            assert a.injected.keys() == b.injected.keys()
            for k in b.injected:
                np.testing.assert_array_equal(a.injected[k], b.injected[k])
    assert isinstance(tds.make_dataset(cfg), tds.SyntheticDataset)
