"""Local mapping backend (per-keyframe map maintenance).

Host-side rebuild of `LocalMapping` (src/mapping/local_mapper.cpp): the
pipeline per keyframe is ProcessNewKeyFrame -> MapPointCulling ->
CreateNewMapPointsOverride -> SearchInNeighbors -> LocalBundleAdjustment ->
KeyFrameCullingOverride (spinOnce, local_mapper.cpp:47-127).  Geometry and
matching run in the device stages (slam/kernels.py); graph surgery stays
host-side.

The port of the JAX package's slam/local_mapping.py: the synchronous
`spin_once` drive, the mapping thread of the online mode with the
stop/accept/interruptBA protocol, the init-time global BA, the staged
global-BA write-back of loop closing and the hand-off of each processed
keyframe to the loop closer.

The online mode's threads share one device and one CUDA stream: each
backend thread makes the device and stream of the thread that started it
current on entry (`enter_device`), so the card runs their work in launch
order, and the map lock orders the launches that touch the map's device
tensors.  A backend thread that raises records the exception (`error`)
and ends; the System re-raises it at its next frame or at shutdown
(`raise_backend_error`), and `drain` raises when its deadline passes
with work still queued: a deliberate difference from the JAX package,
whose dead thread leaves `drain` to return silently.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.optim import ba as ba_mod
from sp_orb_slam_tpu_torch.slam.depth_filter import DepthFilter
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels, upload
from sp_orb_slam_tpu_torch.slam.map import KeyFrame, Map
from sp_orb_slam_tpu_torch.utils.precision import full_f32


def enter_device(device: torch.device, stream) -> None:
    """Make `device` and `stream` (None off the card) current in a new
    thread, which starts on device 0 and its default stream."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.set_stream(stream)


def current_stream(device: torch.device):
    """The calling thread's current stream on `device` (None off the
    card): the stream a backend thread it starts will launch on."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def raise_backend_error(name: str, error: Optional[BaseException]) -> None:
    """Re-raise the exception that ended backend thread `name`."""
    if error is not None:
        raise RuntimeError(f"the {name} thread failed: {error!r}") from error


def _assemble_ba(world: Map, kf_ids: List[int], fixed_ids: List[int],
                 pids: List[int], caps):
    """Pack a BA problem into fixed-capacity arrays."""
    C, P, O = caps
    all_kfs = list(kf_ids) + list(fixed_ids)
    if len(all_kfs) > C:
        raise ValueError(f"BA camera overflow: {len(all_kfs)} > {C}")
    kf_index = {k: i for i, k in enumerate(all_kfs)}
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    fixed = np.ones(C, bool)
    for k, i in kf_index.items():
        poses[i] = world.keyframes[k].Tcw
        fixed[i] = (k in fixed_ids) or (k == world.kf_origin)
    pids = pids[:P]
    pt_index = {p: i for i, p in enumerate(pids)}
    points = np.zeros((P, 3), np.float32)
    pt_valid = np.zeros(P, bool)
    for p, i in pt_index.items():
        points[i] = world.pool.pos[p]
        pt_valid[i] = True

    obs_cam = np.zeros(O, np.int32)
    obs_pt = np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 2), np.float32)
    obs_w = np.ones((O, 2), np.float32)
    obs_valid = np.zeros(O, bool)
    obs_ref = []  # (kf_id, pid) per slot, for erasure write-back
    o = 0
    dropped = 0  # points excluded to avoid partial constraints
    partial: List[int] = []
    for p, pi in pt_index.items():
        mp = world.points[p]
        start = o
        overflow = False
        for kf_id, idx in mp.obs.items():
            ci = kf_index.get(kf_id)
            if ci is None:
                continue  # observer outside the problem (boundary cap)
            if o >= O:
                overflow = True
                continue
            kf = world.keyframes[kf_id]
            obs_cam[o] = ci
            obs_pt[o] = pi
            obs_uv[o] = kf.data.uv[idx]
            obs_w[o] = kf.data.cov2_inv[idx]
            obs_valid[o] = True
            obs_ref.append((kf_id, p))
            o += 1
        if overflow or (o - start) < 2:
            # A point optimized against a SUBSET of its in-problem
            # observations slides to fit only those views and the
            # write-back commits the bias (the corruption the
            # assemble_global_ba docstring warns about); < 2 edges is
            # unconstrained along the ray.  Exclude the point entirely:
            # its packed edges go inert and the write-back skips it.
            obs_valid[start:o] = False
            pt_valid[pi] = False
            partial.append(p)
            dropped += 1
    for p in partial:
        del pt_index[p]
    return (poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv, obs_w,
            obs_valid, kf_index, pt_index, obs_ref, dropped)


def _solve_ba(kernels: TrackingKernels, packed, **kw):
    """The device solve of an assembled BA problem (one packed upload, one
    readback of poses, points and the bad-observation mask)."""
    (poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv, obs_w,
     obs_valid) = packed
    args = upload((poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv,
                   obs_w, obs_valid), kernels.device)
    with torch.inference_mode(), full_f32():
        res = ba_mod.bundle_adjust(*args, kernels.K_intr, **kw)
        C, P = poses.shape[0], points.shape[0]
        flat = torch.cat([res.poses.reshape(-1), res.points.reshape(-1),
                          res.bad_obs.float()]).cpu().numpy()
    return ba_mod.BAResult(flat[:C * 16].reshape(C, 4, 4),
                           flat[C * 16:C * 16 + P * 3].reshape(P, 3),
                           flat[C * 16 + P * 3:] > 0.5, None)


def _writeback_ba(world: Map, res, kf_index, pt_index, obs_ref, fixed,
                  pt_obj):
    """`pt_obj` (pid -> MapPoint captured at assemble time) guards against
    pool-slot reuse between assembly and write-back: a pid culled and
    re-allocated resolves to a DIFFERENT live point, which a bad-flag check
    alone cannot detect."""
    world.ba_epoch += 1
    poses = np.asarray(res.poses)
    points = np.asarray(res.points)
    for k, i in kf_index.items():
        if not fixed[i]:
            world.keyframes[k].set_pose(poses[i])
    for p, i in pt_index.items():
        mp = world.points.get(p)
        if mp is not None and mp is pt_obj[p] and not mp.bad:
            world.pool.pos[p] = points[i]
            world.update_normal_and_depth(mp)
    bad = np.asarray(res.bad_obs)
    for o, (kf_id, p) in enumerate(obs_ref):
        if bad[o]:
            mp = world.points.get(p)
            if mp is not None and mp is pt_obj[p] and not mp.bad:
                world.erase_observation(mp, kf_id)


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def assemble_global_ba(world: Map, caps=None) -> dict:
    """Snapshot the full-map BA problem.

    Capacities auto-size to the next power of two (a truncated global BA
    optimizes a subset against partial constraints and *corrupts* the rest;
    the pow2 sizes keep the problem shapes the JAX package solves)."""
    kf_ids = [k for k, kf in world.keyframes.items() if not kf.bad]
    pids = [p for p, mp in world.points.items() if not mp.bad]
    if caps is None:
        n_obs = sum(world.points[p].n_obs for p in pids)
        caps = (_next_pow2(max(len(kf_ids), 2)),
                _next_pow2(max(len(pids), 64)),
                _next_pow2(max(n_obs, 256)))
    (poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv, obs_w,
     obs_valid, kf_index, pt_index, obs_ref, dropped) = _assemble_ba(
        world, kf_ids, [], pids, caps)
    obs_w[:] = 1.0  # optimizer.cpp:131-132 uses pyramid sigma (= 1), not cov
    return dict(poses=poses, fixed=fixed, points=points, pt_valid=pt_valid,
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_w=obs_w,
                obs_valid=obs_valid, kf_index=kf_index, pt_index=pt_index,
                pt_obj={p: world.points[p] for p in pt_index})


def solve_global_ba(problem: dict, kernels: TrackingKernels, iters: int = 20):
    """The device solve of a global BA snapshot."""
    p = problem
    return _solve_ba(kernels, tuple(p[k] for k in (
        "poses", "fixed", "points", "pt_valid", "obs_cam", "obs_pt",
        "obs_uv", "obs_w", "obs_valid")), iters1=iters, two_phase=False,
        robust=True)


def apply_global_ba_direct(world: Map, problem: dict, res) -> None:
    """Direct write-back (the nLoopKF == 0 path of optimizer.cpp:200-228:
    init-time GBA where nothing ran concurrently).  Plain BA does not erase
    observations (optimizer.cpp:42-229)."""
    world.ba_epoch += 1
    poses_np = np.asarray(res.poses)
    points_np = np.asarray(res.points)
    fixed = problem["fixed"]
    for k, i in problem["kf_index"].items():
        if not fixed[i]:
            world.keyframes[k].set_pose(poses_np[i])
    pt_obj = problem["pt_obj"]
    for p, i in problem["pt_index"].items():
        mp = world.points.get(p)
        if mp is not None and mp is pt_obj[p] and not mp.bad:
            world.pool.pos[p] = points_np[i]


def apply_global_ba_staged(world: Map, problem: dict, res,
                           loop_kf_id: int) -> None:
    """Staged write-back with spanning-tree propagation: the commit phase of
    RunGlobalBundleAdjustment (loop_closer_vlad.cpp:771-849).

    Call holding the map lock with the mapper stopped.  Keyframes and
    points created while the solve ran are not in the problem: a new KF
    inherits its correction through its spanning-tree parent
    (T_child_gba = T_child * T_parent^-1 * T_parent_gba, :783-795); a new
    point re-projects through its reference KF's pre/post-GBA pose pair
    (:815-845)."""
    from collections import deque

    world.ba_epoch += 1
    poses_np = np.asarray(res.poses)
    points_np = np.asarray(res.points)
    fixed = problem["fixed"]
    # stage the solved poses (mTcwGBA / mnBAGlobalForKF)
    for k, i in problem["kf_index"].items():
        kf = world.keyframes.get(k)
        if kf is None:
            continue
        kf.Tcw_gba = kf.Tcw.copy() if fixed[i] else poses_np[i].copy()
        kf.ba_global_for = loop_kf_id
    # BFS the spanning tree from the origin (FIFO like the reference's
    # lpKFtoCheck): children created during GBA chain through their
    # parent's current (pre-commit) pose, then the parent commits
    queue = deque([world.kf_origin])
    while queue:
        kid = queue.popleft()
        kf = world.keyframes.get(kid)
        if kf is None:
            continue
        Twc = np.linalg.inv(kf.Tcw.astype(np.float64))
        for c in kf.children:
            child = world.keyframes.get(c)
            if child is None:
                continue
            if child.ba_global_for != loop_kf_id:
                if kf.Tcw_gba is None:
                    continue  # parent untouched: nothing to chain
                Tchildc = child.Tcw.astype(np.float64) @ Twc
                child.Tcw_gba = (Tchildc @ kf.Tcw_gba.astype(np.float64)
                                 ).astype(np.float32)
                child.ba_global_for = loop_kf_id
            queue.append(c)
        if kf.Tcw_gba is not None and kf.ba_global_for == loop_kf_id:
            kf.Tcw_bef_gba = kf.Tcw.copy()
            kf.set_pose(kf.Tcw_gba)
    # points: participants take the solved position; points born during the
    # solve re-project through their reference keyframe's pose pair
    pt_index = problem["pt_index"]
    pt_obj = problem["pt_obj"]
    for p, mp in list(world.points.items()):
        if mp.bad:
            continue
        i = pt_index.get(p)
        # identity check: a pool slot culled and re-allocated during the
        # solve holds a different point, which takes the re-projection path
        if i is not None and pt_obj.get(p) is mp:
            world.pool.pos[p] = points_np[i]
            world.update_normal_and_depth(mp)
            continue
        ref = world.keyframes.get(mp.ref_kf)
        if (ref is None or ref.ba_global_for != loop_kf_id
                or ref.Tcw_bef_gba is None):
            continue
        Tb = ref.Tcw_bef_gba.astype(np.float64)
        Xc = Tb[:3, :3] @ world.pool.pos[p].astype(np.float64) + Tb[:3, 3]
        Twc_new = np.linalg.inv(ref.Tcw.astype(np.float64))
        world.pool.pos[p] = (Twc_new[:3, :3] @ Xc
                             + Twc_new[:3, 3]).astype(np.float32)
        world.update_normal_and_depth(mp)


def run_global_ba(world: Map, kernels: TrackingKernels, iters: int = 20,
                  caps=None) -> None:
    """Synchronous GlobalBundleAdjustemnt (optimizer.cpp:42-229) — the
    init-time path (mono_tracker.cpp:170) and the offline deterministic
    drive."""
    problem = assemble_global_ba(world, caps)
    res = solve_global_ba(problem, kernels, iters=iters)
    apply_global_ba_direct(world, problem, res)


class LocalMapping:
    """Two drive modes, like the reference (system.cpp:94-97, 176-178):
    `spin_once` runs the pipeline synchronously after each frame (the
    deterministic offline mode), `start`/`run` spins it on its own thread
    with the stop/accept/interruptBA protocol (local_mapper.h:42-56,
    local_mapper.cpp:129-229).  The map-wide `map.update_lock` serializes
    every map-mutating stage against tracking; the keyframe queue is a
    deque mutated only by append/popleft, so there is no second lock.  The
    local-BA solve runs outside the map lock and its result is discarded
    when a new keyframe interrupted it (mbAbortBA, optimizer.cpp:660-671).
    The tracker reads `accepting` (KF pacing) and `stopped`."""

    def __init__(self, cfg: Config, world: Map, kernels: TrackingKernels):
        import collections

        self.cfg = cfg
        self.map = world
        self.k = kernels
        self.queue = collections.deque()
        self.recent_pids: List[int] = []
        self.stopped = False
        self.stop_requested = False
        self.accepting = True
        self.abort_ba = False
        self.current_kf: Optional[KeyFrame] = None
        self._pace = 0  # offline not-accepting countdown (offline_kf_pace)
        self.looper = None  # set by System when use_loop
        self._thread = None
        self._shutdown = False
        self._busy = False  # the thread holds a popped keyframe
        self.error: Optional[BaseException] = None  # what ended the thread
        self.depth_filter = (DepthFilter(cfg, world, kernels.K_np)
                             if cfg.mapping.depth_filter.enabled else None)
        # map points the triangulation passes committed (direct, rescued
        # and promoted from seeds)
        self.n_tri_points = 0

    # ------------------------------------------------------------------ API

    def insert_keyframe(self, kf_id: int) -> None:
        self.queue.append(kf_id)
        self.abort_ba = True

    def interrupt_ba(self) -> None:
        self.abort_ba = True

    # stop/accept protocol (RequestStop/isStopped/Release,
    # local_mapper.cpp:~300; localization mode and loop correction freeze
    # the mapper with it)
    def request_stop(self) -> None:
        self.stop_requested = True
        self.abort_ba = True
        if self._thread is None:
            self.stopped = True  # offline: no thread to reach the check

    def release(self) -> None:
        self.stop_requested = False
        self.stopped = False

    def wait_until_stopped(self, timeout: float = 10.0) -> bool:
        """True once the thread has parked (at once offline); False when
        `timeout` seconds pass first.  Raises if the thread died."""
        t0 = time.monotonic()
        while not self.stopped:
            raise_backend_error("local mapping", self.error)
            if self._thread is None or time.monotonic() - t0 > timeout:
                return self.stopped
            time.sleep(1e-3)
        return True

    def stop(self, timeout: float = 10.0) -> None:
        """request_stop + wait_until_stopped, raising when the thread does
        not park within `timeout` seconds."""
        self.request_stop()
        if not self.wait_until_stopped(timeout):
            raise TimeoutError(f"the local mapping thread did not stop "
                               f"within {timeout} s")

    # ----------------------------------------------------------- drive modes

    def _pop_keyframe(self) -> Optional[KeyFrame]:
        while True:
            try:
                kf_id = self.queue.popleft()
            except IndexError:
                return None
            kf = self.map.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                return kf

    def _pipeline(self, kf: KeyFrame) -> None:
        """One keyframe through the mapping pipeline
        (local_mapper.cpp:47-127 offline / :129-229 online: the same
        stages, the map-mutating ones under the map lock)."""
        lock = self.map.update_lock
        self.current_kf = kf
        with lock:
            self.process_new_keyframe(kf)
            self.map_point_culling(kf)
            self.create_new_map_points(kf)
        if not self.queue:
            with lock:
                self.search_in_neighbors(kf)
        self.abort_ba = False
        if not self.queue and not (self.stopped or self.stop_requested):
            if self.map.n_keyframes() > 2:
                self.local_bundle_adjustment(kf)
            if self.cfg.mapping.culling_kf:
                with lock:
                    self.keyframe_culling(kf)
        if self.looper is not None:
            self.looper.insert_keyframe(kf.kf_id)

    def spin_once(self) -> None:
        """local_mapper.cpp:47-127 (deterministic offline drive mode).

        Offline pacing (offline_kf_pace): after ingesting a keyframe the
        mapper reports not-accepting for the next `pace` frames, emulating
        the online backend's processing latency; otherwise the KF policy's
        `idle` term fires every frame and creates consecutive
        near-zero-baseline keyframe bursts."""
        if self.stopped:
            return
        processed = False
        while True:
            kf = self._pop_keyframe()
            if kf is None:
                break
            self._pipeline(kf)
            processed = True
        pace = self.cfg.mapping.offline_kf_pace
        if self._thread is None and pace > 0:
            if processed:
                self._pace = pace
                self.accepting = False
            elif self._pace > 0:
                self._pace -= 1
                self.accepting = self._pace <= 0
            else:
                self.accepting = True

    def start(self) -> None:
        """Spawn the mapping thread (online mode; system.cpp:94-97) on the
        caller's device and stream."""
        if self._thread is not None:
            return
        self._shutdown = False
        self._thread = threading.Thread(
            target=self.run, args=(current_stream(self.k.device),),
            name="local_mapping", daemon=True)
        self._thread.start()

    def run(self, stream=None) -> None:
        """LocalMapping::Run (local_mapper.cpp:129-229).  An exception ends
        the thread and is kept in `error`."""
        try:
            enter_device(self.k.device, stream)
            while not self._shutdown:
                if self.stop_requested:
                    self.stopped = True
                    time.sleep(1e-3)
                    continue
                self.stopped = False
                self._busy = True
                kf = self._pop_keyframe()
                if kf is None:
                    self._busy = False
                    self.accepting = True
                    time.sleep(1e-3)
                    continue
                self.accepting = False
                self._pipeline(kf)
                self._busy = False
                if not self.queue:
                    self.accepting = True
        except Exception as e:  # re-raised by the System
            self.error = e
        finally:
            self._busy = False

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the queue is empty and the thread idle (or parked by
        a stop request); raise when `timeout` seconds pass first or when
        the thread died.  Nothing to wait for without a thread."""
        t0 = time.monotonic()
        # the queue before the busy flag: the thread sets the flag before
        # it pops, so an empty queue read first cannot miss a held KF
        while (self.queue or self._busy) and not self.stopped:
            raise_backend_error("local mapping", self.error)
            if self._thread is None:
                return
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"local mapping did not drain within {timeout} s "
                    f"({len(self.queue)} keyframes queued)")
            time.sleep(1e-3)
        raise_backend_error("local mapping", self.error)

    def join(self, timeout: float = 30.0) -> None:
        """End the thread without draining it and wait for it."""
        t = self._thread
        if t is None:
            return
        self._shutdown = True
        t.join(timeout=timeout)
        if t.is_alive():
            raise TimeoutError(f"the local mapping thread did not end "
                               f"within {timeout} s")
        self._thread = None

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain the queue, then end the thread and join it."""
        if self._thread is None:
            return
        self.drain(timeout)
        self.join()

    # ------------------------------------------------------------- pipeline

    def process_new_keyframe(self, kf: KeyFrame) -> None:
        """local_mapper.cpp:242-279."""
        for i, pid in enumerate(kf.mp_ids):
            if pid < 0:
                continue
            mp = self.map.get_point(int(pid))
            if mp is None or mp.bad:
                kf.mp_ids[i] = -1
                continue
            if kf.kf_id not in mp.obs:
                self.map.add_observation(mp, kf.kf_id, i)
                self.map.update_normal_and_depth(mp)
                self.map.compute_distinctive_descriptor(mp)
                self.map.update_desc_track(mp, kf.kf_id, i)
            else:
                self.recent_pids.append(mp.pid)
        self.map.update_connections(kf)

    def map_point_culling(self, kf: KeyFrame) -> None:
        """local_mapper.cpp:281-310 (mono thresholds)."""
        kept = []
        for pid in self.recent_pids:
            mp = self.map.points.get(pid)
            if mp is None or mp.bad:
                continue
            if mp.found_ratio() < 0.25:
                self.map.set_point_bad(mp)
            elif kf.kf_id - mp.first_kf >= 2 and mp.n_obs <= 2:
                self.map.set_point_bad(mp)
            elif kf.kf_id - mp.first_kf >= 3:
                pass  # graduated
            else:
                kept.append(pid)
        self.recent_pids = kept

    def create_new_map_points(self, kf: KeyFrame) -> None:
        """CreateNewMapPointsOverride (local_mapper.cpp:558-814).

        With the depth filter enabled, candidates passing the geometric
        gates but exceeding the relative depth-uncertainty bound tau/z
        (both views) are deferred into Bayesian seeds instead of inserted
        — the working version of the reference's vestigial DepthFilter
        (depth_filter.cpp:35-60); see slam/depth_filter.py."""
        df = self.depth_filter
        dfc = self.cfg.mapping.depth_filter
        n_direct = 0
        n_recent = len(self.recent_pids)
        deferred = []  # (rel, kf2_id, j, i, X) for the starvation guard
        neighbors = kf.best_covisible(self.cfg.mapping.triangulation_num_kfs)
        Ow1 = kf.Ow
        # One readback for ALL neighbor pairs.  The free masks are
        # snapshots of the pre-pass state — the sequential loop's "raced
        # within this pass" guard below already makes cross-neighbor slot
        # claims safe, exactly like the reference's own per-pass
        # GetMapPointMatches snapshot semantics.
        free1 = kf.data.valid & (kf.mp_ids < 0)
        rows, pair_kfs = [], []
        for kid in neighbors:
            kf2 = self.map.keyframes.get(kid)
            if kf2 is None or kf2.bad:
                continue
            baseline = float(np.linalg.norm(kf2.Ow - Ow1))
            median_depth = self._scene_median_depth(kf2)
            if median_depth <= 0 or baseline / median_depth < 0.01:
                continue
            free2 = kf2.data.valid & (kf2.mp_ids < 0)
            rows.append((kf.Tcw, kf2.Tcw, kf.data.uv, kf.data.desc_dev,
                         kf.data.cov2_inv, free1, kf2.data.uv,
                         kf2.data.desc_dev, kf2.data.cov2_inv, free2))
            pair_kfs.append(kf2)
        outs = self.k.triangulate_pair_batch(rows) if rows else []
        for kf2, out in zip(pair_kfs, outs):
            good = out["good"]
            match21 = out["match21"]
            if df is not None:
                with np.errstate(divide="ignore", invalid="ignore"):
                    rel = np.maximum(out["tau1"] / np.maximum(out["z1"], 1e-9),
                                     out["tau2"] / np.maximum(out["z2"], 1e-9))
                certain = good & (rel <= dfc.max_rel_sigma)
                seedable = good & ~certain
                good = certain
            for j in np.nonzero(good)[0]:
                i = int(match21[j])
                if kf.mp_ids[i] >= 0 or kf2.mp_ids[j] >= 0:
                    continue  # raced within this pass
                mp = self.map.create_point(out["points"][j], kf.kf_id)
                mp.first_kf = kf.kf_id
                self.map.add_observation(mp, kf.kf_id, i)
                self.map.add_observation(mp, kf2.kf_id, int(j))
                self.map.compute_distinctive_descriptor(mp)
                self.map.update_desc_track(mp, kf.kf_id, i)
                self.map.update_normal_and_depth(mp)
                self.recent_pids.append(mp.pid)
                n_direct += 1
            if df is not None:
                # route deferred candidates into seeds; promote converged
                seedable &= (kf.mp_ids[np.clip(match21, 0, None)] < 0)
                seedable &= (kf2.mp_ids < 0)
                for j in np.nonzero(seedable)[0]:
                    deferred.append((float(rel[j]), kf2.kf_id, int(j),
                                     int(match21[j]), out["points"][j]))
                for owner_id, slot, other_id, oidx in df.observe_pair(
                        kf, kf2, out, seedable):
                    self._promote_seed(owner_id, slot, other_id, oidx)
        if df is not None:
            # Starvation guard: pure deferral through a degenerate segment
            # (turn apex) removes exactly the points the new viewing
            # direction needs and tracking dies on the far side.  Keep the
            # map fed with the *least-uncertain* deferred candidates —
            # but ONLY when the keyframe is actually starving (few bound
            # map points): a healthy KF with hundreds of bindings that
            # happens to triangulate little new must not get uncertain
            # points force-fed (measured: that re-poisoned the
            # BA-repaired map during the frame-17-21 KF burst).
            n_bound = int((kf.mp_ids >= 0).sum())
            if (n_direct < dfc.min_direct_inserts
                    and n_bound < dfc.starve_bound_th):
                deferred.sort(key=lambda c: c[0])
                for rel_j, kf2_id, j, i, X in deferred:
                    if n_direct >= dfc.min_direct_inserts:
                        break
                    kf2 = self.map.keyframes.get(kf2_id)
                    if kf2 is None or kf2.bad:
                        continue
                    if kf.mp_ids[i] >= 0 or kf2.mp_ids[j] >= 0:
                        continue
                    mp = self.map.create_point(X, kf.kf_id)
                    mp.first_kf = kf.kf_id
                    self.map.add_observation(mp, kf.kf_id, i)
                    self.map.add_observation(mp, kf2.kf_id, j)
                    self.map.compute_distinctive_descriptor(mp)
                    self.map.update_desc_track(mp, kf.kf_id, i)
                    self.map.update_normal_and_depth(mp)
                    self.recent_pids.append(mp.pid)
                    n_direct += 1
                    df.n_rescued += 1
            df.prune(kf.kf_id)
        self.n_tri_points += len(self.recent_pids) - n_recent

    def _promote_seed(self, owner_id: int, slot: int, other_id: int,
                      oidx: int) -> None:
        """Insert a converged seed as a map point observed in the owner KF
        and the partner of the converging measurement."""
        df = self.depth_filter
        owner = self.map.keyframes.get(owner_id)
        other = self.map.keyframes.get(other_id)
        if owner is None or owner.bad or other is None or other.bad:
            return
        if owner.mp_ids[slot] >= 0 or other.mp_ids[oidx] >= 0:
            return
        X = df.point_from_seed(owner, slot)
        if X is None or not np.all(np.isfinite(X)):
            return
        # positive-depth sanity in both views (the posterior can drift
        # outside the frustum when late measurements were outliers)
        for k_ in (owner, other):
            if float(k_.Tcw[2, :3] @ X + k_.Tcw[2, 3]) <= 0:
                return
        mp = self.map.create_point(X, owner_id)
        mp.first_kf = self.current_kf.kf_id if self.current_kf else owner_id
        self.map.add_observation(mp, owner_id, slot)
        self.map.add_observation(mp, other_id, oidx)
        self.map.compute_distinctive_descriptor(mp)
        self.map.update_desc_track(mp, owner_id, slot)
        self.map.update_normal_and_depth(mp)
        self.recent_pids.append(mp.pid)
        df.n_promoted += 1

    def _scene_median_depth(self, kf: KeyFrame) -> float:
        return self.map.scene_median_depth(kf)

    def search_in_neighbors(self, kf: KeyFrame) -> None:
        """SearchInNeighbors (local_mapper.cpp:816-904)."""
        targets = []
        seen = set()
        for kid in kf.best_covisible(20):
            nkf = self.map.keyframes.get(kid)
            if nkf is None or nkf.bad or kid in seen:
                continue
            targets.append(kid)
            seen.add(kid)
            for kid2 in nkf.best_covisible(5):
                n2 = self.map.keyframes.get(kid2)
                if n2 is None or n2.bad or kid2 in seen or kid2 == kf.kf_id:
                    continue
                targets.append(kid2)
                seen.add(kid2)

        cur_pids = [int(p) for p in kf.mp_ids if p >= 0]
        # current KF's points into each target — ONE readback for all ~20
        # targets.  Projections read the pre-phase snapshot, like the
        # reference's own vpMapPointMatches snapshot (local_mapper.cpp:
        # 846-852); the apply loop re-checks live point state per row.
        rows, metas = [], []
        for kid in targets:
            tkf = self.map.keyframes[kid]
            built = self._fuse_row(tkf, cur_pids)
            if built is not None:
                rows.append(built[0])
                metas.append((tkf, built[1]))
        outs = self.k.fuse_batch(rows) if rows else []
        for (tkf, tpids), out in zip(metas, outs):
            self._fuse_apply(tkf, tpids, out)
        # target KFs' points into the current KF
        cand = []
        cseen = set()
        for kid in targets:
            for pid in self.map.keyframes[kid].mp_ids:
                if pid >= 0 and pid not in cseen:
                    cseen.add(int(pid))
                    cand.append(int(pid))
        self._fuse(kf, cand)

        for pid in kf.mp_ids:
            if pid >= 0:
                mp = self.map.get_point(int(pid))
                if mp is not None and not mp.bad:
                    self.map.compute_distinctive_descriptor(mp)
                    self.map.update_normal_and_depth(mp)
        self.map.update_connections(kf)

    def _fuse(self, kf: KeyFrame, pids: List[int]) -> None:
        """Host surgery around the fuse kernel (sp_matcher.cpp:1086-1100)."""
        built = self._fuse_row(kf, pids)
        if built is None:
            return
        out = self.k.fuse(*built[0])
        self._fuse_apply(kf, built[1], out)

    def _fuse_row(self, kf: KeyFrame, pids: List[int]):
        """Assemble one fuse-kernel arg row for ``kf`` (None if nothing to
        fuse); returns (args, filtered_pids) for self.k.fuse/fuse_batch."""
        pids = [p for p in pids
                if (mp := self.map.get_point(p)) is not None and not mp.bad
                and kf.kf_id not in mp.obs]
        if not pids:
            return None
        L = self.cfg.runtime.local_points_cap
        pids = pids[:L]
        pool = self.map.pool
        idx = np.asarray(pids, np.int64)
        pos = np.zeros((L, 3), np.float32)
        normal = np.zeros((L, 3), np.float32)
        dmin = np.zeros(L, np.float32)
        dmax = np.zeros(L, np.float32)
        valid = np.zeros(L, bool)
        rows = np.zeros(L, np.int32)
        n = len(pids)
        pos[:n] = pool.pos[idx]
        rows[:n] = idx
        normal[:n] = pool.normal[idx]
        dmin[:n] = pool.min_dist[idx]
        dmax[:n] = pool.max_dist[idx]
        valid[:n] = True
        # Fuse uses GetDescriptor (distinctive); gathered on the device
        # from the pool bank
        desc = self.k.gather_rows(pool.device_bank("desc"), rows, valid)
        args = (kf.Tcw, pos, desc, normal, dmin, dmax, valid,
                kf.data.uv, kf.data.desc_dev, kf.data.valid)
        return args, pids

    def _fuse_apply(self, kf: KeyFrame, pids: List[int], out) -> None:
        best_idx = out["best_idx"]
        n = len(pids)
        for li in range(n):
            bi = int(best_idx[li])
            if bi < 0:
                continue
            mp = self.map.get_point(pids[li])
            if mp is None or mp.bad or kf.kf_id in mp.obs:
                continue
            existing_pid = int(kf.mp_ids[bi])
            if existing_pid >= 0:
                other = self.map.get_point(existing_pid)
                if other is not None and not other.bad and other.pid != mp.pid:
                    if other.n_obs > mp.n_obs:
                        self.map.replace_point(mp, other)
                    else:
                        self.map.replace_point(other, mp)
            else:
                self.map.add_observation(mp, kf.kf_id, bi)

    def local_bundle_adjustment(self, kf: KeyFrame) -> None:
        """optimizer.cpp:445-774: the problem assembled and the result
        written back under the map lock, the device solve outside it (the
        tracker runs during the solve)."""
        with self.map.update_lock:
            problem = self._assemble_local_ba(kf)
        if problem is None:
            return
        packed, pt_obj = problem
        (poses, fixd, points, pt_valid, obs_cam, obs_pt, obs_uv, obs_w,
         obs_valid, kf_index, pt_index, obs_ref, dropped) = packed
        res = _solve_ba(self.k, packed[:9], iters1=5, iters2=10,
                        two_phase=True, robust=True)
        # mbAbortBA semantics (optimizer.cpp:510-511,660-671): a keyframe
        # that arrived during the solve discards a stale optimum
        if self.abort_ba:
            return
        with self.map.update_lock:
            if self.abort_ba:
                return
            _writeback_ba(self.map, res, kf_index, pt_index, obs_ref, fixd,
                          pt_obj)

    def _assemble_local_ba(self, kf: KeyFrame):
        """The local window around `kf` packed for the solve, with the
        point objects captured for the write-back; None when it overflows
        the camera cap."""
        rt = self.cfg.runtime
        local = [kf.kf_id] + [k for k in kf.ordered_neighbors
                              if not self.map.keyframes[k].bad]
        local = local[:rt.ba_kfs_cap // 2]
        local_set = set(local)
        pids = []
        pseen = set()
        for kid in local:
            for pid in self.map.keyframes[kid].mp_ids:
                if pid >= 0 and pid not in pseen:
                    mp = self.map.get_point(int(pid))
                    if mp is not None and not mp.bad:
                        pseen.add(int(pid))
                        pids.append(mp.pid)
        fixed = []
        fseen = set(local_set)
        for p in pids:
            for kid in self.map.points[p].obs:
                if kid not in fseen:
                    fkf = self.map.keyframes.get(kid)
                    if fkf is not None and not fkf.bad:
                        fixed.append(kid)
                    fseen.add(kid)
        fixed = fixed[:rt.ba_kfs_cap - len(local)]
        # Gauge anchoring (deviation from the reference, which pins only KF
        # id 0, optimizer.cpp:524): with no fixed boundary observers a
        # monocular local BA has an exact free scale gauge; in float32 the
        # optimizer spreads per-KF drift along that valley and the map scale
        # random-walks.  Pin the oldest local KF as a second anchor whenever
        # the boundary is empty.
        if not fixed and len(local) > 2:
            non_origin = [k for k in local if k != self.map.kf_origin]
            oldest = min(non_origin)
            local = [k for k in local if k != oldest]
            fixed = [oldest]
        caps = (rt.ba_kfs_cap, rt.ba_points_cap, rt.ba_obs_cap)
        try:
            packed = _assemble_ba(self.map, local, fixed, pids, caps)
        except ValueError:
            return None
        return packed, {p: self.map.points[p] for p in packed[10]}

    def _redundancy(self, ckf: KeyFrame, *, strict: bool = False):
        """(ratio, n_mp): share of this KF's tracked points observed by
        >= (or strictly >, `strict`) kf_culling_num_obs keyframes."""
        th = self.cfg.mapping.kf_culling_num_obs
        n_mp = 0
        n_red = 0
        for pid in ckf.mp_ids:
            if pid < 0:
                continue
            mp = self.map.get_point(int(pid))
            if mp is None or mp.bad:
                continue
            n_mp += 1
            if (mp.n_obs > th) if strict else (mp.n_obs >= th):
                n_red += 1
        return n_red / max(n_mp, 1), n_mp

    def keyframe_culling(self, kf: KeyFrame) -> None:
        """Dispatch on mapping.kf_culling_method — the reference keeps
        three compiled variants (local_mapper.cpp:906-1097)."""
        method = self.cfg.mapping.kf_culling_method
        if method == "override2":
            return self._keyframe_culling_override2(kf)
        if method == "plain":
            return self._keyframe_culling_plain(kf)
        return self._keyframe_culling_override(kf)

    def _keyframe_culling_plain(self, kf: KeyFrame) -> None:
        """KeyFrameCulling (local_mapper.cpp:1034-1097): one pass over the
        covisibles, cull every KF whose redundancy (observations strictly
        > num_obs; the scale condition is inert with the 1-level SP
        pyramid) exceeds the ratio."""
        for kid in list(kf.ordered_neighbors):
            ckf = self.map.keyframes.get(kid)
            if ckf is None or ckf.bad or kid == self.map.kf_origin:
                continue
            ratio, n_mp = self._redundancy(ckf, strict=True)
            if n_mp and ratio > self.cfg.mapping.kf_culling_cov_ratio:
                self.map.erase_keyframe(ckf)

    def _keyframe_culling_override2(self, kf: KeyFrame) -> None:
        """KeyFrameCullingOverride2 (local_mapper.cpp:906-977): drop
        below-ratio covisibles from the worklist; among the above-ratio
        candidates cull the one closest to its spanning-tree parent
        (minimum baseline = least depth information lost); repeat."""
        worklist = [k for k in kf.ordered_neighbors
                    if k != self.map.kf_origin]
        while worklist:
            candidates = []
            for kid in list(worklist):
                ckf = self.map.keyframes.get(kid)
                if ckf is None or ckf.bad:
                    worklist.remove(kid)
                    continue
                ratio, _ = self._redundancy(ckf)
                if ratio < self.cfg.mapping.kf_culling_cov_ratio:
                    worklist.remove(kid)
                else:
                    candidates.append(ckf)
            best = None
            best_dist = np.inf
            for ckf in candidates:
                parent = self.map.keyframes.get(ckf.parent)
                if parent is None:
                    continue
                dist = float(np.linalg.norm(ckf.Ow - parent.Ow))
                if dist < best_dist:
                    best_dist = dist
                    best = ckf
            if best is None:
                break
            self.map.erase_keyframe(best)
            if best.kf_id in worklist:
                worklist.remove(best.kf_id)

    def _keyframe_culling_override(self, kf: KeyFrame) -> None:
        """KeyFrameCullingOverride (local_mapper.cpp:979-1032): repeatedly
        cull the covisible KF with the highest redundant-observation ratio
        above the threshold."""
        candidates = [k for k in kf.ordered_neighbors
                      if k != self.map.kf_origin]
        alive = set(candidates)
        while alive:
            best_ratio = 0.0
            best = None
            for kid in list(alive):
                ckf = self.map.keyframes.get(kid)
                if ckf is None or ckf.bad:
                    alive.discard(kid)
                    continue
                n_mp = 0
                n_red = 0
                for pid in ckf.mp_ids:
                    if pid < 0:
                        continue
                    mp = self.map.get_point(int(pid))
                    if mp is None or mp.bad:
                        continue
                    n_mp += 1
                    if mp.n_obs >= self.cfg.mapping.kf_culling_num_obs:
                        n_red += 1
                ratio = n_red / max(n_mp, 1)
                if ratio < self.cfg.mapping.kf_culling_cov_ratio:
                    alive.discard(kid)
                elif ratio > best_ratio:
                    best_ratio = ratio
                    best = kid
            if best is None:
                break
            self.map.erase_keyframe(self.map.keyframes[best])
            alive.discard(best)
