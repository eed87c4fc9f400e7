"""The heat coarse tracker of the port (coarse_method="heat":
PoseOptimizationHeat, optimizer_dust.cpp:415-522, and trackFrameHeat,
tracker_dust.cpp:405-446) against the JAX package, on the CPU:

(a) `pose_optimization_heat` on tests/test_heat_tracking.py's bowl: the
    inlier masks and counts equal, the pose within 1e-4 of JAX's through
    the descent and within twice the JAX package's own one-ulp drift over
    the full 40 iterations (see the test), and the same convergence (the
    perturbation is visible, the error halves and ends under a pixel,
    > 80 % inliers);
(b) the `heat_track` stage (packed upload and readback) against the JAX
    package's unpacked fields on a synthetic frame;
(c) the synthetic heat rail (tests/test_heat_tracking.py's config, 40
    frames, seed 6) through both Systems, the port taking the JAX init
    draws: 0 LOST, >= 5 keyframes, the coarse stage carrying some frames,
    the port's ATE < 0.7 and within 0.02 of JAX's, keyframes and points
    within 15 %;
(d) a 2-stream heat fleet equals two heat Systems, each stream on its own
    (per-stream heat stages, no batched dust stage).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.optim import pose as jpose
from sp_orb_slam_tpu.slam import kernels as jk
from sp_orb_slam_tpu.slam import tracking as jtr
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.optim import pose as tpose
from sp_orb_slam_tpu_torch.slam import kernels as tk
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
from sp_orb_slam_tpu_torch.slam.system import System
from tests.test_torch_slam_kernels import _perturb, _points, _tcw
from tests.test_torch_system import SMALL, JaxInitDraws, _ate

torch.set_num_threads(2)

TOL = 1e-4
HEAT = {**SMALL, "tracking": {"num_features": 250, "coarse_method": "heat"}}
RAIL = dict(n_frames=40, n_points=5000, seed=6, pixel_noise=0.3)


def _bowl(rng):
    """tests/test_heat_tracking.py:13-52's inputs: 64 points, their
    distance-transform heat bowl at 320x240, a few-pixel perturbation."""
    from scipy.ndimage import distance_transform_edt

    H, W = 240, 320
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    N = 64
    Xw = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                   rng.uniform(3, 6, N)], -1).astype(np.float32)
    u = K[0] * Xw[:, 0] / Xw[:, 2] + K[2]
    v = K[1] * Xw[:, 1] / Xw[:, 2] + K[3]
    ok = (u > 8) & (u < W - 8) & (v > 8) & (v < H - 8)
    img = np.ones((H, W), bool)
    img[np.clip(v[ok].astype(int), 0, H - 1),
        np.clip(u[ok].astype(int), 0, W - 1)] = False
    heat = np.clip(0.03 * distance_transform_edt(img), 0,
                   0.9).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] += [0.02, -0.015, 0.0]
    return T0, Xw, ok, heat, K, (u, v)


def _heat_pose(mod, to, T0, Xw, ok, heat, K, **kw):
    return mod.pose_optimization_heat(to(T0), to(Xw), to(ok), to(heat), to(K),
                                      **kw)


def test_pose_optimization_heat_matches_jax(rng):
    """Through the descent (12 iterations) the pose agrees at 1e-4.  Over
    the default 40 the LM walks the flat bottom of the bowl (every point
    inlier, chi2 near 0), where the JAX package's own pose moves by up to
    2e-3 when one input coordinate moves by one float32 ulp: there the
    port's pose is held at twice that drift, measured here, and the inlier
    masks and counts must be equal."""
    T0, Xw, ok, heat, K, (u, v) = _bowl(rng)
    args = (T0, Xw, ok, heat, K)
    runs = {}
    for iters in (12, 40):
        want = _heat_pose(jpose, jnp.asarray, *args, iters=iters)
        got = _heat_pose(tpose, torch.from_numpy, *args, iters=iters)
        np.testing.assert_array_equal(got.inlier.numpy(),
                                      np.asarray(want.inlier))
        assert int(got.n_inlier) == int(want.n_inlier)
        runs[iters] = (got.Tcw.numpy(), np.asarray(want.Tcw))
    np.testing.assert_allclose(*runs[12], atol=TOL)
    drift = 0.0
    moves = np.random.default_rng(0)
    for _ in range(8):
        X2 = Xw.copy()
        i, j = moves.integers(len(X2)), moves.integers(3)
        X2[i, j] = np.nextafter(X2[i, j], np.float32(np.inf))
        moved = _heat_pose(jpose, jnp.asarray, T0, X2, ok, heat, K)
        drift = max(drift, float(np.abs(np.asarray(moved.Tcw)
                                         - runs[40][1]).max()))
    diff = float(np.abs(runs[40][0] - runs[40][1]).max())
    assert diff <= max(2.0 * drift, TOL), (diff, drift)

    def reproj_err(T):
        Xc = Xw @ T[:3, :3].T + T[:3, 3]
        uu = K[0] * Xc[:, 0] / Xc[:, 2] + K[2]
        vv = K[1] * Xc[:, 1] / Xc[:, 2] + K[3]
        return np.hypot(uu - u, vv - v)[ok].mean()

    e0, e1 = reproj_err(T0), reproj_err(runs[40][0])
    assert e0 > 1.0
    assert e1 < 0.5 * e0, (e0, e1)
    assert e1 < 1.0, (e0, e1)
    assert int(got.n_inlier) > 0.8 * ok.sum()


@pytest.fixture(scope="module")
def heat_scene():
    return JSynthetic(jmerge(JConfig(), HEAT), n_frames=12, n_points=3000,
                      seed=6, pixel_noise=0.3)


def _heat_args(scene, i=5):
    inj = scene.frame(i).injected
    prev = scene.frame(i - 1).injected
    pos, desc, valid = _points(scene, prev["point_ids"][prev["valid"]], 128,
                               i)
    return (_perturb(_tcw(scene, i), i), pos, desc, valid, inj["heat"],
            inj["occ_grid"], inj["desc"], inj["uv"],
            np.ones_like(inj["uv"]), inj["valid"])


def test_heat_track_stage_matches_jax(heat_scene):
    args = _heat_args(heat_scene)
    want = jk.TrackingKernels(jmerge(JConfig(), HEAT)).heat_track(*args)
    got = tk.TrackingKernels(_merge_dataclass(Config(), HEAT),
                             device="cpu").heat_track(*args)
    assert set(got) == set(want)
    for k in want:
        if k.startswith("Tcw"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_match"] > 40 and got["n_opt"] > 40, got["n_match"]


def test_heat_rail_matches_jax():
    jcfg, cfg = jmerge(JConfig(), HEAT), _merge_dataclass(Config(), HEAT)
    jsys = JSystem(jcfg)
    jsys.spin(JSynthetic(jcfg, **RAIL))
    ds = SyntheticDataset(cfg, **RAIL)
    tsys = System(cfg, device="cpu")
    tsys.tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)
    calls = {"heat": 0, "dust": 0}
    for name in calls:
        fn = getattr(tsys.kernels, f"{name}_track")

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        setattr(tsys.kernels, f"{name}_track", spy)
    tsys.spin(ds)
    jrep, trep = jsys.report(), tsys.report()
    assert jsys.tracker.state == jtr.OK and jrep["n_lost"] == 0, jrep
    assert tsys.tracker.state == ttr.OK and trep["n_lost"] == 0, trep
    assert trep["n_keyframes"] >= 5, trep
    assert trep["n_fail_dust"] < trep["n_frames"], trep
    assert calls["heat"] > 0 and calls["dust"] == 0, calls
    j_ate, t_ate = _ate(jsys, ds).rmse, _ate(tsys, ds).rmse
    assert t_ate < 0.7 and abs(t_ate - j_ate) < 0.02, (t_ate, j_ate)
    for k in ("n_keyframes", "n_points"):
        assert abs(trep[k] - jrep[k]) <= 0.15 * jrep[k], (k, trep, jrep)


def test_heat_fleet_matches_systems():
    cfg = _merge_dataclass(Config(), HEAT)
    streams = [list(SyntheticDataset(cfg, n_frames=24, seed=s))
               for s in (1, 2)]
    fleet = StreamFleet(cfg, 2, params=None, device="cpu")
    for s in fleet.systems:
        s.tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)
    poses = [[], []]
    for k in range(24):
        for i, p in enumerate(fleet.tick([st[k] for st in streams])):
            if p is not None:
                poses[i].append(p)
    assert fleet.n_batched_dust == 0
    for i, stream in enumerate(streams):
        solo = System(cfg, kernels=fleet.kernels, device="cpu")
        solo.tracker._init_draws = JaxInitDraws(
            cfg.runtime.init_ransac_iters)
        solo_poses = [p for p in map(solo.run, stream) if p is not None]
        assert fleet.systems[i].tracker.state == ttr.OK
        assert solo.tracker.state == ttr.OK
        assert fleet.systems[i].report()["n_lost"] == 0
        assert len(solo_poses) == len(poses[i]) > 10
        for a, b in zip(solo_poses, poses[i]):
            np.testing.assert_allclose(a, b, atol=5e-4)


def full_res_variants(package: str, n_frames: int = 120) -> dict:
    """The heat coarse tracker with the epipolar walk (chip_smoke.py phase
    10's configuration: Config() defaults at 752x480, K=896, float32, with
    coarse_method="heat" and matching_method=2) over the first `n_frames`
    frames of the held-out rendered room 5 with the trained weights,
    through the JAX package's System or the port's on the CPU: the report,
    the Sim3 ATE and the spin's wall seconds.  Too slow for the test suite
    (minutes); run it as `JAX_PLATFORMS=cpu python -m
    tests.test_torch_heat_tracking {jax|port} [n_frames]`."""
    import os
    import time

    weights = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "weights", "sp_rendered.npz")
    over = {"tracking": {"coarse_method": "heat"},
            "mapping": {"matching_method": 2}}
    if package == "jax":
        from sp_orb_slam_tpu.io.render import RenderedDataset
        from sp_orb_slam_tpu.models.weights import load_checkpoint

        cfg = jmerge(JConfig(), over)
        sys_ = JSystem(cfg, params=load_checkpoint(weights))
    else:
        from sp_orb_slam_tpu_torch.io.render import RenderedDataset
        from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

        cfg = _merge_dataclass(Config(), over)
        sys_ = System(cfg, params=load_checkpoint(weights), device="cpu")
    ds = RenderedDataset(cfg, n_frames=220, seed=5, noise_seed=0)
    frames = [ds.frame(i) for i in range(n_frames)]  # before the clock
    t0 = time.perf_counter()
    sys_.spin(frames)
    wall = time.perf_counter() - t0
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    out = dict(package=package, n_frames=n_frames, ate_rmse=float(ate.rmse),
               wall_s=wall, report=sys_.report())
    if package != "jax":
        out["tri_rows"] = dict(sys_.kernels.tri_rows)
        out["tri_points"] = sys_.mapper.n_tri_points
    return out


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(full_res_variants(sys.argv[1], *map(int, sys.argv[2:])),
                     default=str))
