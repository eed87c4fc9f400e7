"""System orchestrator: wiring, the offline spin loop, trajectory export.

The port of the JAX package's slam/system.py (include/orb_slam/system.h,
src/system.cpp, src/system_helper.cpp): builds the map, tracking and local
mapping on one device, drives frames through them and exports TUM / KITTI
/ EuRoC trajectories by re-chaining relative poses through (possibly
culled) reference keyframes (system_helper.cpp:89-318).  Two drive modes,
as the reference's: the deterministic offline mode spins mapping (and
loop closing) synchronously after each frame (system.cpp:176-178); the
online mode (`cfg.online`) runs them on their own threads beside tracking
(system.cpp:92-115), started by the first frame and joined by `shutdown`.
`warmup` runs every device stage once before the first frame.  Map
save/load (slam/serialize.py), localization mode and loop closing
(slam/loop_closing.py, with NetVLAD place recognition computed on the
device at keyframe promotion) are here; N systems can share one
TrackingKernels (slam/fleet.py).  The viewer menu's pause / step gate,
the debug dumps (`set_debug_dir`: viz/) and the live viewer's publish hook
(viz/live.py) are the reference's Pangolin viewer (src/viz/viewer.cpp).
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.io.dataset import RawFrame, make_dataset
from sp_orb_slam_tpu_torch.slam.frame import FrameData, frame_from_features
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
from sp_orb_slam_tpu_torch.slam.local_mapping import (LocalMapping,
                                                      raise_backend_error)
from sp_orb_slam_tpu_torch.slam.map import Map
from sp_orb_slam_tpu_torch.slam.tracking import Tracking
from sp_orb_slam_tpu_torch.utils.timing import Timer


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def rechain_trajectory(world, rel_poses, refs, times):
    """Absolute Twc per tracked frame from (Tcr, ref KF) records, re-chained
    through surviving spanning-tree ancestors (SaveTrajectoryTUM,
    system_helper.cpp:89-158): each culled hop right-multiplies its Tcp."""
    ts, poses = [], []
    for rel, ref_id, t in zip(rel_poses, refs, times):
        kf = world.keyframes.get(ref_id)
        if kf is None:
            continue
        Trw = np.eye(4, dtype=np.float32)
        while kf.bad:
            Trw = Trw @ kf.Tcp
            kf = world.keyframes.get(kf.parent)
            if kf is None:
                break
        if kf is None:
            continue
        ts.append(t)
        poses.append(np.linalg.inv(rel @ (Trw @ kf.Tcw)))
    return np.asarray(ts), np.asarray(poses)


def build_preprocess(cfg: Config, device: torch.device):
    """Rectification on the device when the stream is distorted (the
    reference pre-rectifies with initUndistortRectifyMap + remap,
    data_loader.cc:470-489,517-527): a EuRoC stream is remapped from the
    raw cam0 calibration (EurocDataset.RAW_K) to the configured camera.
    None for undistorted streams."""
    from sp_orb_slam_tpu_torch.geometry import camera as cam_ops
    from sp_orb_slam_tpu_torch.io.dataset import EurocDataset

    cam = cfg.camera
    dist = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], np.float32)
    if not np.any(dist):
        return None
    K = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], device=device)
    K_raw = (torch.from_numpy(EurocDataset.RAW_K).to(device)
             if cfg.dataset.startswith("euroc") else K)
    grid = cam_ops.rectify_map(K, K_raw, torch.from_numpy(dist).to(device),
                               cam.height, cam.width)
    return lambda img: cam_ops.bilinear_remap(img, grid)


class System:
    def __init__(self, cfg: Config, params=None,
                 kernels: Optional[TrackingKernels] = None,
                 device: str | torch.device = "cuda"):
        """`params`: the frontend's state dict (models/weights.py), needed
        for image datasets; every stage runs on `device`, the card unless
        the caller passes "cpu" (without a card this raises).  `kernels`
        optionally injects a shared TrackingKernels on the same device: its
        stages hold no per-run state, so N systems (slam/fleet.py) share
        one."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the system on the CPU")
        self.cfg = cfg
        self.device = dev
        self.map = Map(device=dev)
        if kernels is not None and kernels.device != dev:
            raise ValueError(f"shared kernels run on {kernels.device}, the "
                             f"system on {dev}")
        self.kernels = (kernels if kernels is not None
                        else TrackingKernels(cfg, device=dev))
        self.mapper = LocalMapping(cfg, self.map, self.kernels)
        self.tracker = Tracking(cfg, self.map, self.kernels, self.mapper)
        self.looper = None
        if cfg.use_loop:
            from sp_orb_slam_tpu_torch.slam.loop_closing import LoopClosing

            self.looper = LoopClosing(cfg, self.map, self.kernels,
                                      self.mapper)
            self.mapper.looper = self.looper
            if cfg.loop.global_desc_source != "dataset":
                self.map.global_desc_fn = self._make_global_desc_fn()
        self.frame_id = 0
        # interactive gating and mode toggles (the reference's global::b_*
        # atomics written by the viewer menu, viz/viewer.cpp:56-126, and
        # consumed by System::spin/run, system.cpp:141-233)
        self.paused = False
        self.step_once = False           # process one frame while paused
        self._local_on = False           # pending ActivateLocalizationMode
        self._local_off = False          # pending DeactivateLocalizationMode
        self._system_reset = False       # pending resetSystem
        self.debug_dir: Optional[str] = None
        self.viewer = None               # live HTTP viewer (viz/live.py)
        self._extract = None
        self._preprocess = None
        self._prefetched = None          # (raw, features) in flight
        self._next_raw = None            # spin's lookahead frame, if any
        if params is not None:
            from sp_orb_slam_tpu_torch.extractor import make_extractor

            self._extract = make_extractor(cfg, params, device=dev)
            self._preprocess = build_preprocess(cfg, dev)
        self.timer = Timer()

    def warmup(self) -> None:
        """Run every device stage this system can reach once before the
        first frame (TrackingKernels.warmup, LoopClosing.warmup, the
        place-recognition hook and the extractor at B=1), so kernel builds,
        library loads and first-use allocations leave the first frames."""
        self.kernels.warmup(pool_capacity=self.map.pool.capacity)
        if self.looper is not None:
            self.looper.warmup()
        K = self.cfg.runtime.max_keypoints
        if self.map.global_desc_fn is not None:
            valid = np.zeros(K, bool)
            valid[:32] = True
            self.map.global_desc_fn(SimpleNamespace(
                global_desc=None, valid=valid,
                desc_dev=torch.zeros((K, 256), device=self.device)))
        if self._extract is not None:
            H, W = self.cfg.camera.height, self.cfg.camera.width
            img = torch.zeros((H, W), device=self.device)
            if self._preprocess is not None:
                img = self._preprocess(img)
            self.kernels.fetch_features_host(self._extract(img[None]))

    def _make_global_desc_fn(self):
        """NetVLAD place recognition on the system's device
        (models/netvlad.py), run at keyframe promotion by Map.add_keyframe
        and by relocalization: "auto" fills only frames the dataset left
        without a descriptor, "vlad" always recomputes
        (config.py LoopConfig.global_desc_source)."""
        from sp_orb_slam_tpu_torch.models import netvlad

        lc = self.cfg.loop
        params = (netvlad.load_params(lc.netvlad_weights)
                  if lc.netvlad_weights else
                  netvlad.init_params(n_clusters=lc.netvlad_clusters,
                                      out_dim=lc.global_desc_dim))
        vlad = netvlad.NetVLAD(params, device=self.device)

        def fn(frame):
            if frame.global_desc is not None and lc.global_desc_source != "vlad":
                return None
            valid = torch.from_numpy(frame.valid).to(self.device)
            return vlad(frame.desc_dev, valid).cpu().numpy()

        return fn

    # ------------------------------------------------------------ frame feed

    def _frame_from_injected(self, raw: RawFrame) -> FrameData:
        inj = raw.injected
        dev = self.device
        f = FrameData(
            frame_id=self.frame_id, timestamp=raw.timestamp,
            uv=inj["uv"], score=inj["score"],
            response=inj.get("response", inj["score"]), valid=inj["valid"],
            cov2_inv=inj["cov2_inv"], occ_grid=inj["occ_grid"],
            count=inj["count"], global_desc=raw.global_desc,
            desc_dev=torch.as_tensor(inj["desc"], device=dev),
            dust_dev=torch.as_tensor(inj["dust"], device=dev),
            occ_grid_dev=torch.as_tensor(inj["occ_grid"], device=dev),
            heat_dev=(torch.as_tensor(inj["heat"], device=dev)
                      if inj.get("heat") is not None else None))
        f._desc_host = inj["desc"]
        return f

    def _dispatch_extract(self, raw: RawFrame):
        """Enqueue the extraction of ``raw`` and return its features without
        reading anything back: the card runs it while the host works."""
        img = raw.image.astype(np.float32) / 255.0
        H, W = self.cfg.camera.height, self.cfg.camera.width
        img = torch.from_numpy(img[:H, :W]).to(self.device)  # crop (system.cpp:160-161)
        if self._preprocess is not None:
            img = self._preprocess(img)
        return self._extract(img[None])

    def _frame_from_image(self, raw: RawFrame) -> FrameData:
        if self._prefetched is not None and self._prefetched[0] is raw:
            feats = self._prefetched[1]
        else:
            feats = self._dispatch_extract(raw)
        self._prefetched = None
        host = self.kernels.fetch_features_host(feats)
        f = frame_from_features(feats, 0, self.frame_id, raw.timestamp, host)
        f.global_desc = raw.global_desc
        return f

    def process(self, raw: RawFrame) -> None:
        if self.cfg.online:
            self.start_threads()
        with self.timer.span("tracking/frame"):
            if raw.injected is not None:
                frame = self._frame_from_injected(raw)
            else:
                frame = self._frame_from_image(raw)
        self.process_frame(frame, raw)

    def process_frame(self, frame: FrameData,
                      raw: Optional[RawFrame] = None) -> None:
        """Track one frame whose features are already extracted."""
        if self.cfg.online:
            self.start_threads()
        with self.timer.span("tracking/total"):
            self.tracker.track_frame(frame)
        self._post_track(frame, raw)

    def _post_track(self, frame: FrameData,
                    raw: Optional[RawFrame] = None) -> None:
        """Everything after tracking: the next frame's extraction prefetch,
        the debug dumps and the viewer's publish, reset handling, the
        offline mapping and loop spins, frame counting."""
        # enqueue the NEXT frame's extraction before this frame's host work
        # (the debug PNGs, the mapping spin) so the card runs it while the
        # host is busy (extraction is a pure function of the image: the
        # result is the same either way)
        nxt = self._next_raw
        if (nxt is not None and self.cfg.runtime.prefetch_extract
                and nxt.injected is None and self._extract is not None
                and self._prefetched is None):
            self._prefetched = (nxt, self._dispatch_extract(nxt))
        if self.debug_dir is not None and raw is not None:
            self._write_debug(raw, frame)
        if self.viewer is not None:
            self.viewer.publish(raw, frame, self._state_name(),
                                dust_pids=self.tracker.last_dust_pids)
        if self.tracker.request_reset:
            self.reset()
            return
        if not self.cfg.online:
            with self.timer.span("mapping"):
                self.mapper.spin_once()
            if self.looper is not None:
                with self.timer.span("loop"):
                    self.looper.spin_once()
        self.frame_id += 1

    # -------------------------------------------------------- observability

    def _state_name(self) -> str:
        from sp_orb_slam_tpu_torch.slam import tracking as tr

        return {tr.OK: "OK", tr.LOST: "LOST"}.get(self.tracker.state, "INIT")

    def set_debug_dir(self, path: Optional[str]) -> None:
        """Enable (a path) or disable (None) the per-frame overlay PNGs and
        the periodic map snapshots under `path`/frames and `path`/map (the
        offline equivalent of the reference's Pangolin viewer, viz/*)."""
        self.debug_dir = path
        if path:
            os.makedirs(os.path.join(path, "frames"), exist_ok=True)
            os.makedirs(os.path.join(path, "map"), exist_ok=True)

    def _write_debug(self, raw: RawFrame, frame: FrameData) -> None:
        """The frame's overlay PNG, and a map PNG every 20th frame and on
        LOST, drawn under the map lock (online, the mapper writes the map
        beside this)."""
        from sp_orb_slam_tpu_torch.viz import draw_frame, draw_map, save_png

        state = self._state_name()
        img = draw_frame(frame, self.map,
                         dust_pids=self.tracker.last_dust_pids,
                         image=raw.image, K_intr=self.kernels.K_np,
                         state=state)
        save_png(os.path.join(self.debug_dir, "frames",
                              f"{self.frame_id:06d}.png"), img)
        if self.frame_id % 20 == 0 or state == "LOST":
            with self.map.update_lock:
                _, poses = self.trajectory()
                traj = poses[:, :3, 3] if len(poses) else None
                draw_map(self.map,
                         os.path.join(self.debug_dir, "map",
                                      f"{self.frame_id:06d}.png"),
                         current_kf=self.tracker.ref_kf, trajectory=traj)

    # ------------------------------------------------------- mode toggles

    def activate_localization_mode(self) -> None:
        """Queue the switch to tracking-only (ActivateLocalizationMode):
        applied at the next `run`/`spin` frame, like the reference's
        `global::b_local_on` flag (system.cpp:203-215)."""
        self._local_on = True
        self._local_off = False

    def deactivate_localization_mode(self) -> None:
        self._local_off = True
        self._local_on = False

    def request_system_reset(self) -> None:
        """The viewer-menu Reset (`global::b_system_reset`,
        system.cpp:222-226)."""
        self._system_reset = True

    def _apply_pending_toggles(self) -> None:
        if self._local_on:
            # stop the mapper (and wait for its thread to park, online) so
            # the map is frozen, then inform the tracker (system.cpp:204-215)
            self.mapper.stop()
            self.tracker.only_tracking = True
            self._local_on = False
        if self._local_off:
            self.tracker.only_tracking = False
            self.mapper.release()
            self._local_off = False
        if self._system_reset:
            self.reset()
            self._system_reset = False

    def run(self, raw: RawFrame) -> Optional[np.ndarray]:
        """Single-shot API (System::run, system.cpp:202-233): apply pending
        toggles, track one frame, return its Tcw, or None for an invalid
        pose (uninitialized, or LOST: after a LOST frame last_frame.Tcw
        holds the failed stage's predicted pose)."""
        self._apply_pending_toggles()
        self.process(raw)
        return self._last_valid_pose()

    def run_frame(self, frame: FrameData) -> Optional[np.ndarray]:
        """`run` for a pre-built frame."""
        self._apply_pending_toggles()
        self.process_frame(frame)
        return self._last_valid_pose()

    def _last_valid_pose(self) -> Optional[np.ndarray]:
        from sp_orb_slam_tpu_torch.slam.tracking import LOST

        lf = self.tracker.last_frame
        if lf is None or self.tracker.state == LOST:
            return None
        return lf.Tcw

    # ------------------------------------------------------------ threads

    def start_threads(self) -> None:
        """Online mode: mapping (and loop closing) run on their own threads
        on this thread's device and stream (system.cpp:92-115); tracking
        stays on the caller's thread.  Re-raises what ended a backend
        thread."""
        self.raise_backend_error()
        self.mapper.start()
        if self.looper is not None:
            self.looper.start()

    def raise_backend_error(self) -> None:
        """Re-raise the exception that ended a backend thread, if any."""
        raise_backend_error("local mapping", self.mapper.error)
        if self.looper is not None:
            raise_backend_error("loop closing", self.looper.error)

    def shutdown(self, timeout: float = 120.0) -> None:
        """Drain the pipeline and join the backend threads
        (System::Shutdown, system_helper.cpp:59-87); raise when `timeout`
        seconds pass with work still queued or when a backend thread
        failed.  The mapper is drained again after each loop-closer drain:
        a loop correction or GBA commit stops it for a while."""
        deadline = time.monotonic() + timeout
        left = lambda: max(deadline - time.monotonic(), 0.0)
        try:
            while True:
                self.mapper.drain(left())
                if self.looper is None:
                    break
                self.looper.drain(left())
                if not self.mapper.queue or self.mapper.stop_requested:
                    break
        finally:  # joined even when the drain failed
            self._stop_threads(max(left(), 30.0))
        self.raise_backend_error()

    def _stop_threads(self, timeout: float = 60.0) -> None:
        """End and join the backend threads without draining them."""
        if self.looper is not None:
            self.looper.shutdown(timeout)
        self.mapper.join(timeout)

    def spin(self, dataset=None, max_frames: Optional[int] = None) -> None:
        """Run every frame of `dataset` (default: `make_dataset(cfg)`); in
        the online mode drain and join the backend threads at the end
        (they are joined, undrained, when a frame raises)."""
        if dataset is None:
            dataset = make_dataset(self.cfg)
        done = False
        try:
            it = iter(dataset)
            raw = next(it, None)
            i = 0
            while raw is not None:
                if max_frames is not None and i >= max_frames:
                    break
                # one-frame lookahead feeds the extraction prefetch
                nxt = next(it, None)
                if max_frames is not None and i + 1 >= max_frames:
                    nxt = None
                self._next_raw = nxt
                # the viewer menu's pause / step gate (the reference spin's
                # b_pause / b_step check, system.cpp:146-158)
                while self.paused and not self.step_once:
                    time.sleep(1e-2)
                self.step_once = False
                self._apply_pending_toggles()
                self.process(raw)
                raw = nxt
                i += 1
            done = True
        finally:
            self._next_raw = None
            self._prefetched = None
            if self.cfg.online:
                if done:
                    self.shutdown()
                else:
                    self._stop_threads()

    def reset(self) -> None:
        """System::resetSystem (system_helper.cpp:12-52): a fresh map and
        tracker; the trajectory records survive.  Online, the loop thread
        is joined and the mapper stopped before the map is cleared, and
        both run again after."""
        online = self.mapper._thread is not None
        if self.looper is not None:
            # LoopClosing::RequestReset: drop queued KFs, the
            # place-recognition database, the consistency state and any
            # in-flight GBA before its result could land on the cleared
            # map.  The GBA first: its commit runs its own stop/release
            # cycle on the mapper
            self.looper._stop_gba()
            if online:  # its current keyframe must not outlive the map
                self.looper.shutdown()
            self.looper.queue.clear()
            self.looper.db.clear()
            self.looper.consistent_groups.clear()
            self.looper.last_loop_kf = -10 ** 9
        if online:  # freeze the mapping thread before clearing under it
            self.mapper.stop()
        with self.map.update_lock:
            self.map.clear()
            self.mapper.queue.clear()
            self.mapper.recent_pids.clear()
            tr = self.tracker
            self.tracker = Tracking(self.cfg, self.map, self.kernels,
                                    self.mapper)
            self.tracker.only_tracking = tr.only_tracking
            self.tracker.fleet_bank_mode = tr.fleet_bank_mode
            self.tracker.rel_poses = tr.rel_poses
            self.tracker.refs = tr.refs
            self.tracker.times = tr.times
            self.tracker.lost_flags = tr.lost_flags
        if online:
            self.mapper.release()
            self.start_threads()

    # ------------------------------------------------------- map persistence

    def save_map(self, path: str) -> None:
        """Persist the live map (slam/serialize.py): the build-once,
        localize-many serving pattern."""
        from sp_orb_slam_tpu_torch.slam.serialize import save_map

        with self.map.update_lock:
            save_map(self.map, path)

    def load_map(self, path: str) -> None:
        """Replace the current map with a saved one and arm the tracker for
        cold-start relocalization (the first frames enter through the
        multi-start relocalization path instead of two-view init).  Call
        before spinning; typically paired with
        `activate_localization_mode()` to freeze the loaded map."""
        from sp_orb_slam_tpu_torch.slam.serialize import load_map
        from sp_orb_slam_tpu_torch.slam.tracking import LOST

        # online: the old threads end (the mapper parked first, so nothing
        # writes the old map) and new ones start on the loaded map
        was_online = self.mapper._thread is not None
        if was_online:
            self.mapper.stop()
            if self.looper is not None:
                self.looper._stop_gba()
            self._stop_threads()
        hook = self.map.global_desc_fn
        self.map = load_map(path, mp_capacity=self.map.pool.capacity,
                            device=self.device)
        self.map.global_desc_fn = hook
        self.mapper = LocalMapping(self.cfg, self.map, self.kernels)
        if self.looper is not None:
            from sp_orb_slam_tpu_torch.slam.loop_closing import LoopClosing

            self.looper.shutdown()
            self.looper = LoopClosing(self.cfg, self.map, self.kernels,
                                      self.mapper)
            self.mapper.looper = self.looper
        only_tracking = self.tracker.only_tracking
        fleet_bank = self.tracker.fleet_bank_mode
        self.tracker = Tracking(self.cfg, self.map, self.kernels,
                                self.mapper)
        self.tracker.only_tracking = only_tracking
        self.tracker.fleet_bank_mode = fleet_bank
        live = [k for k, kf in self.map.keyframes.items() if not kf.bad]
        if live:
            self.tracker.state = LOST
            self.tracker.ref_kf = max(live)
        if was_online:
            self.start_threads()

    # ------------------------------------------------------------ trajectory

    def trajectory(self):
        """Absolute Twc per tracked frame, re-chained through surviving
        spanning-tree ancestors (system_helper.cpp:89-158)."""
        tr = self.tracker
        return rechain_trajectory(self.map, tr.rel_poses, tr.refs, tr.times)

    def save_trajectory_tum(self, path: str) -> None:
        """SaveTrajectoryTUM (system_helper.cpp:89-158)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ts, poses = self.trajectory()
        with open(path, "w") as f:
            for t, Twc in zip(ts, poses):
                q = _rotmat_to_quat(Twc[:3, :3])
                p = Twc[:3, 3]
                f.write(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """SaveKeyFrameTrajectoryTUM (system_helper.cpp:159-200)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        kfs = sorted((k for k in self.map.keyframes.values() if not k.bad),
                     key=lambda k: k.kf_id)
        with open(path, "w") as f:
            for kf in kfs:
                Twc = np.linalg.inv(kf.Tcw)
                q = _rotmat_to_quat(Twc[:3, :3])
                p = Twc[:3, 3]
                f.write(f"{kf.timestamp:.6f} {p[0]:.7f} {p[1]:.7f} "
                        f"{p[2]:.7f} {q[0]:.7f} {q[1]:.7f} {q[2]:.7f} "
                        f"{q[3]:.7f}\n")

    def save_trajectory_kitti(self, path: str) -> None:
        """SaveTrajectoryKITTI (system_helper.cpp): 3x4 row-major Twc."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _, poses = self.trajectory()
        with open(path, "w") as f:
            for Twc in poses:
                f.write(" ".join(f"{x:.9e}" for x in Twc[:3].ravel()) + "\n")

    def save_trajectory_euroc(self, path: str) -> None:
        """SaveTrajectoryEuroc (system_helper.cpp): nanosecond timestamps +
        position + (w, x, y, z) quaternion, comma-separated."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ts, poses = self.trajectory()
        with open(path, "w") as f:
            for t, Twc in zip(ts, poses):
                q = _rotmat_to_quat(Twc[:3, :3])
                p = Twc[:3, 3]
                f.write(f"{int(t * 1e9)},{p[0]:.7f},{p[1]:.7f},{p[2]:.7f},"
                        f"{q[3]:.7f},{q[0]:.7f},{q[1]:.7f},{q[2]:.7f}\n")

    def report(self) -> dict:
        rep = self.tracker.report()
        rep.update(n_keyframes=self.map.n_keyframes(),
                   n_points=self.map.n_points())
        if self.looper is not None:
            rep["n_loops_closed"] = self.looper.n_loops_closed
        return rep
