"""The port's transient global BA (loop_closer_vlad.cpp:681-690, 753-849)
beside the JAX package's (tests/test_async_gba.py): the post-loop global
BA solves a snapshot outside the map lock while tracking and mapping go
on, commits with staged spanning-tree propagation to keyframes and points
created during the solve, and a new loop kills a GBA still running.

The mini-bundle is built in both packages from the same numbers.  Every
wait has a deadline and fails when it passes.
"""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import torch

from sp_orb_slam_tpu.slam import local_mapping as jlm
from sp_orb_slam_tpu.slam.frame import FrameData as JFrameData
from sp_orb_slam_tpu.slam.map import Map as JMap
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.slam import local_mapping as tlm
from sp_orb_slam_tpu_torch.slam import loop_closing as lc_mod
from sp_orb_slam_tpu_torch.slam.frame import FrameData
from sp_orb_slam_tpu_torch.slam.local_mapping import LocalMapping
from sp_orb_slam_tpu_torch.slam.loop_closing import LoopClosing
from sp_orb_slam_tpu_torch.slam.map import Map

torch.set_num_threads(2)

FX = FY = 260.0
CX, CY = 160.0, 120.0
DEADLINE = 30.0


def _cfg():
    return _merge_dataclass(Config(), {
        "camera": {"width": 320, "height": 240, "fx": FX, "fy": FY,
                   "cx": CX, "cy": CY, "fps": 20.0},
        "runtime": {"max_keypoints": 64},
        "use_loop": True, "loop": {"use_loop": True}})


def _kernels(jax_side=False):
    K = np.asarray([FX, FY, CX, CY], np.float32)
    if jax_side:
        return types.SimpleNamespace(K_intr=jnp.asarray(K))
    return types.SimpleNamespace(K_intr=torch.from_numpy(K), K_np=K,
                                 device=torch.device("cpu"))


def _project(Tcw, P):
    pc = Tcw[:3, :3] @ P + Tcw[:3, 3]
    return np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY],
                    np.float32)


def _frame(fid, jax_side, K=64):
    kw = dict(frame_id=fid, timestamp=fid / 20.0,
              uv=np.zeros((K, 2), np.float32), score=np.zeros(K, np.float32),
              response=np.zeros(K, np.float32), valid=np.ones(K, bool),
              cov2_inv=np.ones((K, 2), np.float32),
              occ_grid=np.full((30, 40), -1, np.int32), count=K,
              desc_dev=None, dust_dev=None, occ_grid_dev=None,
              Tcw=np.eye(4, dtype=np.float32))
    return JFrameData(**kw) if jax_side else FrameData(**kw)


def _build_bundle(jax_side=False, n_kfs=4, n_pts=50, seed=0, perturb=0.02):
    """tests/test_async_gba.py's mini-bundle: cameras on a line, points
    ahead, keyframe poses perturbed so GBA has work, observations exact."""
    rng = np.random.default_rng(seed)
    world = (JMap(mp_capacity=1024) if jax_side
             else Map(mp_capacity=1024, device="cpu"))
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(5.0, 8.0, n_pts)], axis=1).astype(np.float32)
    true_T, kfs = [], []
    for i in range(n_kfs):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-0.25 * i, 0.0, 0.0]
        true_T.append(T)
        f = _frame(i, jax_side)
        for k in range(n_pts):
            f.uv[k] = _project(T, pts[k])
        Tp = T.copy()
        if i > 0:
            Tp[:3, 3] += rng.normal(0, perturb, 3).astype(np.float32)
        f.set_pose(Tp)
        kfs.append(world.add_keyframe(f))
    for k in range(n_pts):
        mp = world.create_point(pts[k], kfs[0].kf_id)
        for kf in kfs:
            world.add_observation(mp, kf.kf_id, k)
    for kf in kfs:
        world.update_connections(kf)
    return world, kfs, pts, true_T


def _staged_run(jax_side):
    """Assemble, then a keyframe and a point born during the solve, then
    the solve and the staged commit; returns the poses and positions."""
    mod = jlm if jax_side else tlm
    world, kfs, _, true_T = _build_bundle(jax_side)
    problem = mod.assemble_global_ba(world)
    T_new = np.eye(4, dtype=np.float32)
    T_new[:3, 3] = [-1.1, 0.0, 0.01]
    f = _frame(99, jax_side)
    f.set_pose(T_new)
    kf_new = world.add_keyframe(f)
    kf_new.parent = kfs[-1].kf_id
    kfs[-1].children.add(kf_new.kf_id)
    p_new = world.create_point(np.array([0.3, 0.2, 6.0], np.float32),
                               kf_new.kf_id)
    world.add_observation(p_new, kf_new.kf_id, 0)
    before = (kfs[-1].Tcw.copy(), kf_new.Tcw.copy(),
              world.pool.pos[p_new.pid].copy())
    res = mod.solve_global_ba(problem, _kernels(jax_side), iters=8)
    mod.apply_global_ba_staged(world, problem, res, loop_kf_id=777)
    return world, kfs, kf_new, p_new, true_T, before


def test_staged_propagation_reaches_kfs_and_points_born_during_gba():
    """The port's staged commit: participants take the solved poses (near
    ground truth), the keyframe born during the solve chains through its
    parent, the point born during it keeps its camera-frame coordinates;
    every pose and the new point agree with the JAX package's at 1e-5."""
    world, kfs, kf_new, p_new, true_T, (parent0, child0, pnew0) = \
        _staged_run(jax_side=False)
    for kf, T_true in zip(kfs[1:], true_T[1:]):
        assert kf.ba_global_for == 777
        assert np.linalg.norm(kf.Tcw[:3, 3] - T_true[:3, 3]) < 0.01
    assert kf_new.ba_global_for == 777
    expect = (child0.astype(np.float64)
              @ np.linalg.inv(parent0.astype(np.float64))
              @ kfs[-1].Tcw.astype(np.float64))
    assert np.allclose(kf_new.Tcw, expect, atol=1e-5)
    Xc0 = child0[:3, :3] @ pnew0 + child0[:3, 3]
    Xc1 = kf_new.Tcw[:3, :3] @ world.pool.pos[p_new.pid] + kf_new.Tcw[:3, 3]
    assert np.allclose(Xc0, Xc1, atol=1e-5)

    jworld, jkfs, jkf_new, jp_new, _, _ = _staged_run(jax_side=True)
    for kf, jkf in zip(kfs + [kf_new], jkfs + [jkf_new]):
        np.testing.assert_allclose(kf.Tcw, jkf.Tcw, atol=1e-5)
        assert kf.ba_global_for == jkf.ba_global_for
    np.testing.assert_allclose(world.pool.pos[p_new.pid],
                               jworld.pool.pos[jp_new.pid], atol=1e-5)


def _threaded_looper(world):
    cfg = _cfg()
    kernels = _kernels()
    looper = LoopClosing(cfg, world, kernels,
                         LocalMapping(cfg, world, kernels))
    looper._thread = object()  # the threaded-launch path
    return looper


def _gated_solve(monkeypatch):
    """Replace the GBA solve with one that signals `solving` and waits for
    `proceed`."""
    solving, proceed = threading.Event(), threading.Event()
    real_solve = lc_mod.solve_global_ba

    def gated(problem, k, iters=10):
        solving.set()
        assert proceed.wait(timeout=DEADLINE)
        return real_solve(problem, k, iters=iters)

    monkeypatch.setattr(lc_mod, "solve_global_ba", gated)
    return solving, proceed


def test_gba_thread_leaves_the_lock_free_then_commits(monkeypatch):
    """While the GBA thread solves, the map lock is free (a tracked frame
    could take it); the staged commit lands after, from that thread."""
    world, kfs, _, true_T = _build_bundle()
    looper = _threaded_looper(world)
    solving, proceed = _gated_solve(monkeypatch)
    committed = []
    real_apply = lc_mod.apply_global_ba_staged

    def watched(*a, **kw):
        committed.append(threading.current_thread().name)
        return real_apply(*a, **kw)

    monkeypatch.setattr(lc_mod, "apply_global_ba_staged", watched)
    looper._launch_gba(kfs[-1].kf_id)
    assert solving.wait(timeout=DEADLINE)
    assert world.update_lock.acquire(timeout=5.0)  # free mid-solve
    world.update_lock.release()
    assert looper.gba_running
    proceed.set()
    looper._gba_thread.join(timeout=DEADLINE)
    assert not looper._gba_thread.is_alive() and looper.error is None
    assert not looper.gba_running
    assert committed == ["global_ba"]
    assert all(kf.ba_global_for == kfs[-1].kf_id for kf in kfs)
    for kf, T_true in zip(kfs[1:], true_T[1:]):
        assert np.linalg.norm(kf.Tcw[:3, 3] - T_true[:3, 3]) < 0.01


def test_new_loop_kills_running_gba(monkeypatch):
    """mbStopGBA (loop_closer_vlad.cpp:511-529): a GBA superseded mid-solve
    discards its result, and the poses stay untouched."""
    world, kfs, _, _ = _build_bundle()
    looper = _threaded_looper(world)
    solving, proceed = _gated_solve(monkeypatch)
    poses_before = [kf.Tcw.copy() for kf in kfs]
    looper._launch_gba(kfs[-1].kf_id)
    assert solving.wait(timeout=DEADLINE)
    killer = threading.Thread(target=looper._stop_gba)
    killer.start()
    t0 = time.monotonic()
    while not looper._gba_stop:  # _stop_gba raised the flag: now join
        assert time.monotonic() - t0 < DEADLINE
        time.sleep(1e-3)
    proceed.set()
    killer.join(timeout=DEADLINE)
    assert not killer.is_alive()
    assert looper._gba_thread is None and looper.error is None
    for kf, T0 in zip(kfs, poses_before):
        assert np.array_equal(kf.Tcw, T0)
        assert kf.ba_global_for == -1
