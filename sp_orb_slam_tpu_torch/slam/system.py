"""System orchestrator: wiring, the offline spin loop, trajectory export.

The port of the JAX package's slam/system.py (include/orb_slam/system.h,
src/system.cpp, src/system_helper.cpp): builds the map, tracking and local
mapping on one device, drives frames through them in the reference's
deterministic offline mode (mapping spins synchronously after each frame,
system.cpp:176-178) and exports TUM / KITTI / EuRoC trajectories by
re-chaining relative poses through (possibly culled) reference keyframes
(system_helper.cpp:89-318).  Loop closing, map save/load, localization
mode and the online threads wait for their slices.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.io.dataset import RawFrame, make_dataset
from sp_orb_slam_tpu_torch.slam.frame import FrameData, frame_from_features
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
from sp_orb_slam_tpu_torch.slam.local_mapping import LocalMapping
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
    data_loader.cc:470-489,517-527).  None for undistorted streams."""
    from sp_orb_slam_tpu_torch.geometry import camera as cam_ops

    cam = cfg.camera
    dist = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], np.float32)
    if not np.any(dist):
        return None
    K = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], device=device)
    grid = cam_ops.rectify_map(K, K, torch.from_numpy(dist).to(device),
                               cam.height, cam.width)
    return lambda img: cam_ops.bilinear_remap(img, grid)


class System:
    def __init__(self, cfg: Config, params=None,
                 device: str | torch.device = "cuda"):
        """`params`: the frontend's state dict (models/weights.py), needed
        for image datasets; every stage runs on `device`, the card unless
        the caller passes "cpu" (without a card this raises)."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the system on the CPU")
        for what, on in (("use_loop (loop closing)", cfg.use_loop),
                         ("online (threaded mapping)", cfg.online)):
            if on:
                raise NotImplementedError(f"{what} is not ported")
        self.cfg = cfg
        self.device = dev
        self.map = Map(device=dev)
        self.kernels = TrackingKernels(cfg, device=dev)
        self.mapper = LocalMapping(cfg, self.map, self.kernels)
        self.tracker = Tracking(cfg, self.map, self.kernels, self.mapper)
        self.frame_id = 0
        self._extract = None
        self._preprocess = None
        self._prefetched = None          # (raw, features) in flight
        self._next_raw = None            # spin's lookahead frame, if any
        if params is not None:
            from sp_orb_slam_tpu_torch.extractor import make_extractor

            self._extract = make_extractor(cfg, params, device=dev)
            self._preprocess = build_preprocess(cfg, dev)
        self.timer = Timer()

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
            occ_grid_dev=torch.as_tensor(inj["occ_grid"], device=dev))
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
        with self.timer.span("tracking/frame"):
            if raw.injected is not None:
                frame = self._frame_from_injected(raw)
            else:
                frame = self._frame_from_image(raw)
        self.process_frame(frame, raw)

    def process_frame(self, frame: FrameData,
                      raw: Optional[RawFrame] = None) -> None:
        """Track one frame whose features are already extracted."""
        with self.timer.span("tracking/total"):
            self.tracker.track_frame(frame)
        self._post_track(frame, raw)

    def _post_track(self, frame: FrameData,
                    raw: Optional[RawFrame] = None) -> None:
        """Everything after tracking: the next frame's extraction prefetch,
        reset handling, the offline mapping spin, frame counting."""
        # enqueue the NEXT frame's extraction before this frame's mapping
        # spin so the card runs it while the host is busy (extraction is a
        # pure function of the image: the result is the same either way)
        nxt = self._next_raw
        if (nxt is not None and self.cfg.runtime.prefetch_extract
                and nxt.injected is None and self._extract is not None
                and self._prefetched is None):
            self._prefetched = (nxt, self._dispatch_extract(nxt))
        if self.tracker.request_reset:
            self.reset()
            return
        with self.timer.span("mapping"):
            self.mapper.spin_once()
        self.frame_id += 1

    def spin(self, dataset=None, max_frames: Optional[int] = None) -> None:
        """Run every frame of `dataset` (default: `make_dataset(cfg)`)."""
        if dataset is None:
            dataset = make_dataset(self.cfg)
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
            self.process(raw)
            raw = nxt
            i += 1
        self._next_raw = None
        self._prefetched = None

    def reset(self) -> None:
        """System::resetSystem (system_helper.cpp:12-52): a fresh map and
        tracker; the trajectory records survive."""
        self.map.clear()
        self.mapper.queue.clear()
        self.mapper.recent_pids.clear()
        tr = self.tracker
        self.tracker = Tracking(self.cfg, self.map, self.kernels, self.mapper)
        self.tracker.rel_poses = tr.rel_poses
        self.tracker.refs = tr.refs
        self.tracker.times = tr.times
        self.tracker.lost_flags = tr.lost_flags

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
        return rep
