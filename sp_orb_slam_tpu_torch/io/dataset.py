"""Dataset loaders: the port's own copy of the JAX package's io/dataset.py
(include/orb_slam/io/data_loader.h, src/io/data_loader.cc).

- `EurocDataset`: cam0/data.csv timestamps + PNGs; the EuRoC
  radial-tangential rectification (data_loader.cc:470-489,517-527) runs on
  the device as frame preprocessing (slam/system.build_preprocess);
- `TsukubaDataset`: NewTsukuba left/frame_%d.png with synthetic 20 fps
  timestamps (data_loader.cc:430-441) and the shared gt.txt;
- `ExportDataset` / `ReferenceExportDataset`: precomputed features
  injected instead of extracted (DataloaderEuRoCExport / KITTIExport,
  data_loader.cc:60-286), in an npz schema or the reference's own byte
  layout;
- `SyntheticDataset`: the deterministic end-to-end rail, a procedural 3D
  scene with persistent descriptors projected per frame with noise.

PNGs decode on the host (io/native_loader.py, PIL without it).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from sp_orb_slam_tpu_torch.config import Config


@dataclass
class RawFrame:
    """A loader output: either an image (extractor path) or injected
    features (export path), mirroring DataFrame (data_loader.h:35-59)."""

    timestamp: float
    image: Optional[np.ndarray] = None        # (H, W) uint8
    gt_pose: Optional[np.ndarray] = None      # (4, 4) Twc ground truth
    injected: Optional[dict] = None           # precomputed feature dict
    global_desc: Optional[np.ndarray] = None  # (D,) place-recognition desc


def load_tum_trajectory(path: str):
    """TUM 8-col (t x y z qx qy qz qw) -> (ts, positions): the format of
    orb_ros/data/tsukuba/gt.txt and of the trajectory files."""
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            ts.append(float(parts[0]))
            pos.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(ts), np.asarray(pos)


class EurocDataset:
    """ASL-format EuRoC: <root>/<seq>/mav0/cam0/data.csv + data/*.png."""

    # hardcoded raw EuRoC cam0 calibration (data_loader.cc:470-489)
    RAW_K = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0],
                    np.float32)

    def __init__(self, root: str, seq: str):
        self.dir = os.path.join(root, seq, "mav0", "cam0")
        if not os.path.isdir(self.dir):  # accept a direct cam0 path too
            self.dir = os.path.join(root, seq)
        self.entries: List[Tuple[float, str]] = []
        with open(os.path.join(self.dir, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                self.entries.append((float(row[0]) * 1e-9,
                                     os.path.join(self.dir, "data",
                                                  row[1].strip())))

    def __len__(self):
        return len(self.entries)

    def __iter__(self) -> Iterator[RawFrame]:
        from sp_orb_slam_tpu_torch.io.native_loader import iter_gray_images

        paths = [p for _, p in self.entries]
        for (ts, _), img in zip(self.entries, iter_gray_images(paths)):
            yield RawFrame(timestamp=ts, image=img)


class TsukubaDataset:
    """NewTsukuba: <root>/left/frame_%d.png at synthetic 20 fps.

    Ground truth: `gt.txt` (TUM 8-col, one row per frame at the same 20 fps;
    all four illumination variants share it), looked up next to the frames
    or one level up."""

    def __init__(self, root: str, fps: float = 20.0, n_frames: int = 1724):
        self.root = root
        self.fps = fps
        self.paths = []
        for i in range(1, n_frames + 1):
            p = os.path.join(root, "left", f"frame_{i}.png")
            if os.path.exists(p):
                self.paths.append(p)
        if not self.paths:
            # other layouts (zero-padded, 0-based, other prefixes) in
            # NUMERIC order: a lexicographic sort of unpadded names
            # (frame_10 before frame_2) would pair frames with the wrong
            # timestamps and ground-truth rows
            import glob
            import re

            def frame_key(p):
                nums = re.findall(r"\d+", os.path.basename(p))
                return (int(nums[-1]) if nums else -1, p)

            self.paths = sorted(glob.glob(os.path.join(root, "left", "*.png")),
                                key=frame_key)
        self.gt = None  # (ts, positions) when gt.txt exists
        for p in (os.path.join(root, "gt.txt"),
                  os.path.join(os.path.dirname(root.rstrip("/")), "gt.txt")):
            if os.path.exists(p):
                self.gt = load_tum_trajectory(p)
                break

    def gt_trajectory(self):
        if self.gt is None:
            raise FileNotFoundError(f"no gt.txt near {self.root}")
        return self.gt

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[RawFrame]:
        from sp_orb_slam_tpu_torch.io.native_loader import iter_gray_images

        for i, img in enumerate(iter_gray_images(self.paths)):
            yield RawFrame(timestamp=i / self.fps, image=img)


def _smooth_trajectory(n: int) -> np.ndarray:
    """Twc poses: a constant-speed forward arc with steady lateral motion.

    Deliberately seed-independent: the dataset seed varies the SCENE
    (point positions + descriptors) — which perturbs every downstream
    measurement — while the camera path stays fixed so per-seed ATE
    numbers are comparable.

    Deliberately non-degenerate: inter-frame baseline stays roughly constant
    so every keyframe pair triangulates with healthy parallax.  (Degenerate
    slow-downs/turn apexes amplify pose error by 1/parallax through
    triangulation — a known monocular failure mode the 5-run protocol of
    the reference tolerates; exercised separately, not in the happy-path
    integration test.)"""
    poses = []
    for i in range(n):
        t = i / max(n - 1, 1)
        # dominantly lateral sweep (strong parallax for every pair) with
        # mild forward drift and slow yaw
        yaw = -0.3 * t
        pos = np.array([4.0 * t,
                        0.2 * np.sin(2 * np.pi * t * 1.5),
                        0.8 * t])
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def _degenerate_trajectory(n: int, *, apex_frac: float = 0.45,
                           apex_len_frac: float = 0.25,
                           apex_yaw: float = 0.55) -> np.ndarray:
    """Twc poses with a *degenerate* segment: the camera decelerates into a
    near-pure-rotation turn apex (inter-frame baseline collapses to ~0 while
    yaw keeps changing), then accelerates out.

    This is the monocular failure mode the reference's 5-run protocol
    tolerates with outright failures: keyframes created at the apex
    triangulate new points with ~zero parallax, whose depth error is
    amplified by 1/parallax and then poisons the pose fit after the apex.
    Used by the depth-filter replay (tests/test_depth_filter.py).
    """
    # arclength profile: smooth-step speed that dips to ~0 inside the apex
    ts = np.arange(n) / max(n - 1, 1)
    a0, a1 = apex_frac, apex_frac + apex_len_frac
    speed = np.ones(n)
    inside = (ts >= a0) & (ts <= a1)
    ph = (ts[inside] - a0) / max(a1 - a0, 1e-9)       # 0..1 inside apex
    speed[inside] = 0.02 + 0.98 * (2 * np.abs(ph - 0.5)) ** 2
    s = np.concatenate([[0.0], np.cumsum(0.5 * (speed[1:] + speed[:-1]))])
    s = s / s[-1]  # normalized arclength 0..1

    poses = []
    for i in range(n):
        t = ts[i]
        # yaw keeps turning through the apex even though translation stalls
        yaw = -0.25 * s[i] * 4.0
        if a0 <= t <= a1:
            ph = (t - a0) / max(a1 - a0, 1e-9)
            yaw += -apex_yaw * 0.5 * (1 - np.cos(np.pi * ph))
        elif t > a1:
            yaw += -apex_yaw
        pos = np.array([4.0 * s[i],
                        0.2 * np.sin(2 * np.pi * s[i] * 1.5),
                        0.8 * s[i]])
        c, sn = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def _loop_trajectory(n: int) -> np.ndarray:
    """A closed circle (camera yawing to face outward) returning to the
    start — the loop-closure test trajectory."""
    poses = []
    radius = 2.0
    for i in range(n):
        t = i / n
        ang = 2 * np.pi * t
        pos = np.array([radius * np.sin(ang), 0.08 * np.sin(4 * np.pi * t),
                        radius * (1 - np.cos(ang))])
        yaw = ang  # tangent heading
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


class SyntheticDataset:
    """Procedural scene with injected features + ground truth.

    Equivalent role to the reference Export loaders (precomputed SP features
    from disk, data_loader.cc:172-179), but generated: a wall of 3D points
    with persistent random unit descriptors, projected per frame with
    noise; the dust map is carved low at feature cells; covariance is
    isotropic.  Gives a deterministic full-pipeline metric rail.
    """

    def __init__(self, cfg: Config, n_frames: int = 120, n_points: int = 4000,
                 seed: int = 0, pixel_noise: float = 0.3,
                 desc_noise: float = 0.01, loop: bool = False,
                 trajectory: str = None):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.n_frames = n_frames
        cam = cfg.camera
        self.K = np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
        # points in a thick shell around the trajectory corridor (for loop
        # trajectories the camera yaws a full turn, so fill all directions)
        if loop:
            self.points = np.stack([
                rng.uniform(-10, 10, n_points),
                rng.uniform(-4, 4, n_points),
                rng.uniform(-8, 12, n_points)], -1).astype(np.float32)
        else:
            self.points = np.stack([
                rng.uniform(-6, 6, n_points),
                rng.uniform(-4, 4, n_points),
                rng.uniform(2, 14, n_points)], -1).astype(np.float32)
        self.loop = loop
        # place-recognition model: random Fourier features of (pos, yaw) —
        # nearby poses give high dot products (the pluggable global_desc
        # source, like the reference's precomputed VLAD files)
        self._rff_w = rng.normal(0, 1.0, (256, 5)).astype(np.float64)
        self._rff_b = rng.uniform(0, 2 * np.pi, 256)
        d = rng.normal(0, 1, (n_points, 256)).astype(np.float32)
        self.descs = d / np.linalg.norm(d, axis=1, keepdims=True)
        # note: per-dim noise sigma n adds a vector of norm ~n*16 to a unit
        # descriptor; keep it well under TH_LOW/sqrt(2) (matching.py)
        if trajectory == "degenerate":
            self.poses = _degenerate_trajectory(n_frames)  # Twc
        elif loop or trajectory == "loop":
            self.poses = _loop_trajectory(n_frames)
        else:
            self.poses = _smooth_trajectory(n_frames)
        self.rng = rng
        self.pixel_noise = pixel_noise
        self.desc_noise = desc_noise

    def _global_desc(self, i: int) -> np.ndarray:
        # length scale 3.0: adjacent-KF similarity stays >= ~0.77 within the
        # covisible window, like real VLAD on consecutive frames — the
        # detection gate is min-over-covisibles (loop_closer_vlad.cpp:
        # 150-165), so an unrealistically sharp similarity kernel would
        # reject genuine revisits that rank below the worst covisible
        Twc = self.poses[i].astype(np.float64)
        yaw = np.arctan2(Twc[0, 2], Twc[0, 0])
        f = np.concatenate([Twc[:3, 3] / 3.0, [np.cos(yaw), np.sin(yaw)]])
        g = np.cos(self._rff_w @ f + self._rff_b)
        return (g / np.linalg.norm(g)).astype(np.float32)

    def __len__(self):
        return self.n_frames

    def frame(self, i: int) -> RawFrame:
        cfg = self.cfg
        cam = cfg.camera
        cell = cfg.extractor.cell_size
        hc, wc = cfg.grid_h, cfg.grid_w
        K_cap = cfg.runtime.max_keypoints
        rng = np.random.default_rng(1000 + i)

        Twc = self.poses[i]
        Tcw = np.linalg.inv(Twc).astype(np.float32)
        pc = self.points @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        vis = z > 0.5
        u = self.K[0] * pc[:, 0] / np.where(vis, z, 1.0) + self.K[2]
        v = self.K[1] * pc[:, 1] / np.where(vis, z, 1.0) + self.K[3]
        u += rng.normal(0, self.pixel_noise, u.shape)
        v += rng.normal(0, self.pixel_noise, v.shape)
        b = cfg.extractor.border
        vis &= (u >= b) & (u < cam.width - b) & (v >= b) & (v < cam.height - b)

        # one keypoint per 8x8 cell (occ-grid invariant): keep nearest point
        occ = np.full((hc, wc), -1, np.int32)
        uv_list, desc_list, order = [], [], []
        cand = np.nonzero(vis)[0]
        cand = cand[np.argsort(z[cand])]  # near points win cells
        for pi in cand:
            cu, cv = int(u[pi]) // cell, int(v[pi]) // cell
            if occ[cv, cu] >= 0:
                continue
            occ[cv, cu] = 1  # placeholder, re-numbered below
            order.append((cv * wc + cu, pi))
        order.sort()  # raster-order emission (extractor semantics)
        order = order[:K_cap]

        uv = np.zeros((K_cap, 2), np.float32)
        desc = np.zeros((K_cap, 256), np.float32)
        valid = np.zeros(K_cap, bool)
        point_ids = np.full(K_cap, -1, np.int64)  # provenance for diagnostics
        occ = np.full((hc, wc), -1, np.int32)
        for k, (cidx, pi) in enumerate(order):
            uv[k] = (u[pi], v[pi])
            dd = self.descs[pi] + rng.normal(0, self.desc_noise, 256)
            desc[k] = dd / np.linalg.norm(dd)
            valid[k] = True
            point_ids[k] = pi
            occ[cidx // wc, cidx % wc] = k

        # dust map: high (uninformative) background, smooth low basin
        # around occupied feature cells
        from scipy.ndimage import distance_transform_edt

        cells = occ >= 0
        dist = distance_transform_edt(~cells)
        dust = np.clip(0.05 + 0.25 * dist, 0.05, 0.85).astype(np.float32)

        # full-resolution heat ("coldness", low at keypoints) for the
        # heat-alignment tracker variant: a distance bowl around keypoints.
        # Only computed when that variant is selected — the full-res EDT
        # costs real CPU per frame across the 5-run x N-seed protocol.
        heat = None
        if self.cfg.tracking.coarse_method == "heat":
            kp_img = np.ones((cam.height, cam.width), bool)
            vi = np.clip(uv[valid, 1].astype(int), 0, cam.height - 1)
            ui = np.clip(uv[valid, 0].astype(int), 0, cam.width - 1)
            kp_img[vi, ui] = False
            heat = np.clip(0.03 * distance_transform_edt(kp_img),
                           0.0, 0.9).astype(np.float32)

        cov2_inv = np.ones((K_cap, 2), np.float32)
        score = np.where(valid, 0.5, 0.0).astype(np.float32)
        return RawFrame(
            timestamp=i / cam.fps,
            gt_pose=Twc,
            global_desc=self._global_desc(i),
            injected=dict(uv=uv, desc=desc, valid=valid, occ_grid=occ,
                          dust=dust, cov2_inv=cov2_inv, score=score,
                          count=int(valid.sum()), point_ids=point_ids,
                          **({"heat": heat} if heat is not None else {})),
        )

    def __iter__(self) -> Iterator[RawFrame]:
        for i in range(self.n_frames):
            yield self.frame(i)

    def gt_trajectory(self):
        """(timestamps, Twc poses) for the evaluator."""
        ts = np.arange(self.n_frames) / self.cfg.camera.fps
        return ts, self.poses


class ExportDataset:
    """Precomputed-feature injection from disk (DataloaderEuRoCExport /
    DataloaderKITTIExport, data_loader.cc:87-179) in an npz schema:
    <root>/frames/%06d.npz with keys uv (K, 2), desc (K, 256), valid (K,),
    occ_grid (hc, wc), dust (hc, wc), cov2_inv (K, 2), score (K,) and
    optionally global_desc (D,); plus timestamps.txt (one float per line).
    `save_frame` writes that format."""

    def __init__(self, root: str):
        import glob

        self.root = root
        self.paths = sorted(glob.glob(os.path.join(root, "frames", "*.npz")))
        ts_file = os.path.join(root, "timestamps.txt")
        if os.path.exists(ts_file):
            with open(ts_file) as f:
                self.timestamps = [float(x) for x in f]
            if len(self.timestamps) < len(self.paths):
                raise ValueError(
                    f"timestamps.txt has {len(self.timestamps)} lines for "
                    f"{len(self.paths)} frames under {root}")
        else:
            self.timestamps = [i / 20.0 for i in range(len(self.paths))]

    def gt_trajectory(self):
        """(ts, positions) from <root>/gt.txt (TUM 8-col), when present."""
        p = os.path.join(self.root, "gt.txt")
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        rows = np.loadtxt(p)
        return rows[:, 0], rows[:, 1:4]

    @staticmethod
    def save_frame(root: str, index: int, injected: dict,
                   global_desc=None) -> None:
        os.makedirs(os.path.join(root, "frames"), exist_ok=True)
        data = dict(injected)
        if global_desc is not None:
            data["global_desc"] = global_desc
        np.savez(os.path.join(root, "frames", f"{index:06d}.npz"), **data)

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[RawFrame]:
        for i, path in enumerate(self.paths):
            with np.load(path) as z:
                inj = {k: z[k] for k in z.files if k != "global_desc"}
                gd = z["global_desc"] if "global_desc" in z.files else None
            inj["count"] = int(inj["valid"].sum())
            yield RawFrame(timestamp=self.timestamps[i], injected=inj,
                           global_desc=gd)


def _read_f32_bin(path: str, shape: tuple) -> np.ndarray:
    """One raw little-endian float32 blob, row-major, no header (the
    reference's readDepthBinary, data_loader.cc:19-38)."""
    n = int(np.prod(shape))
    a = np.fromfile(path, dtype="<f4", count=n)
    if a.size != n:
        raise ValueError(f"{path}: expected {n} float32, got {a.size}")
    return a.reshape(shape)


class ReferenceExportDataset:
    """The reference's Export on-disk layout as it is (DataloaderEuRoCExport
    / DataloaderKITTIExport, data_loader.cc:60-286):

    - ``cam0/data.csv``: header line skipped, the first comma field is the
      nanosecond stamp; timestamps t/1e9 and image paths
      ``cam0/data/<t>.png`` (optional) both come from it (:187-209);
    - NetVLAD descriptors, (1, 4096) raw f32: ``vlad/<t>.bin`` (EuRoC,
      :87-109) or ``vlad/sequences/<seq>/%06d.bin`` (KITTI, :266-276),
      detected from the tree;
    - per-frame features under ``features/%06d/`` (:125-179): ``size``
      (text, first line = num_pts), ``pts.bin`` (num_pts, 3) keypoints
      [u, v, score], ``desc_mat.bin`` (num_pts, 256), ``dust.bin``
      (H/8, W/8) dustbin map, ``dense.bin`` (H-2*border, W-2*border) and
      ``dense_sm.bin`` (H, W) heat maps.

    ``occ_grid`` is rebuilt from the keypoints (the reference NMS keeps at
    most one keypoint per 8x8 cell, sp_extractor.cpp:216-238, so the
    rebuild is exact); ``cov2_inv`` comes from the exported full-res heat
    with the reference's heat_inv normalization and BFS covariance
    (sp_extractor.cpp:461-474, 252-340) when ``cov_from_heat`` is set,
    else unit information."""

    def __init__(self, root: str, seq: Optional[str] = None, *,
                 height: int = 480, width: int = 752, cell: int = 8,
                 border: int = 8, max_keypoints: int = 896,
                 cov_from_heat: bool = False, cov_radius: int = 8,
                 fps_fallback: float = 20.0):
        self.root = root
        self.height, self.width = height, width
        self.cell, self.border = cell, border
        self.max_keypoints = max_keypoints
        self.cov_from_heat = cov_from_heat
        self.cov_radius = cov_radius
        self.entries: List[Tuple[Optional[str], float, Optional[str]]] = []
        csv_path = os.path.join(root, "cam0", "data.csv")
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                f.readline()  # header (data_loader.cc:195-196)
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    t = line.split(",")[0]
                    img = os.path.join(root, "cam0", "data", t + ".png")
                    self.entries.append(
                        (t, float(t) / 1e9,
                         img if os.path.exists(img) else None))
        else:  # feature-only export: enumerate the features/%06d dirs
            feat_root = os.path.join(root, "features")
            idxs = sorted(d for d in os.listdir(feat_root)
                          if d.isdigit()) if os.path.isdir(feat_root) else []
            self.entries = [(None, int(d) / fps_fallback, None)
                            for d in idxs]
        kitti_vlad = os.path.join(root, "vlad", "sequences")
        self.kitti_vlad = os.path.isdir(kitti_vlad)
        if self.kitti_vlad and seq is None:
            seqs = sorted(os.listdir(kitti_vlad))
            seq = seqs[0] if seqs else None
        self.seq = seq

    def _vlad_path(self, i: int) -> Optional[str]:
        if self.kitti_vlad:
            return os.path.join(self.root, "vlad", "sequences",
                                self.seq or "", f"{i:06d}.bin")
        t = self.entries[i][0]
        return (os.path.join(self.root, "vlad", f"{t}.bin")
                if t is not None else None)

    def __len__(self):
        return len(self.entries)

    def frame(self, i: int) -> RawFrame:
        t, ts, img_path = self.entries[i]
        gd = None
        vp = self._vlad_path(i)
        if vp and os.path.exists(vp):
            gd = _read_f32_bin(vp, (4096,))
        image = None
        if img_path:
            from sp_orb_slam_tpu_torch.io.native_loader import (
                iter_gray_images)

            image = next(iter(iter_gray_images([img_path])))
        return RawFrame(timestamp=ts, image=image,
                        injected=self._read_features(i), global_desc=gd)

    def _read_features(self, i: int) -> Optional[dict]:
        fdir = os.path.join(self.root, "features", f"{i:06d}")
        if not os.path.isdir(fdir):
            return None
        with open(os.path.join(fdir, "size")) as f:
            n = int(f.readline().split()[0])
        H, W, c = self.height, self.width, self.cell
        K = self.max_keypoints
        if n > K:
            raise ValueError(f"{fdir}: {n} keypoints > cap {K}")
        pts = _read_f32_bin(os.path.join(fdir, "pts.bin"), (n, 3))
        desc_n = _read_f32_bin(os.path.join(fdir, "desc_mat.bin"), (n, 256))
        dust = _read_f32_bin(os.path.join(fdir, "dust.bin"),
                             (H // c, W // c))
        heat = None
        hp = os.path.join(fdir, "dense_sm.bin")
        if os.path.exists(hp):
            heat = _read_f32_bin(hp, (H, W))

        uv = np.zeros((K, 2), np.float32)
        score = np.zeros(K, np.float32)
        valid = np.zeros(K, bool)
        desc = np.zeros((K, 256), np.float32)
        uv[:n] = pts[:, :2]
        score[:n] = pts[:, 2]
        valid[:n] = True
        desc[:n] = desc_n
        # occ_grid rebuild: ascending-score writes, so the best keypoint
        # owns a (never expected) contested cell
        occ = np.full((H // c, W // c), -1, np.int32)
        cu = np.clip((uv[:n, 0] // c).astype(np.int32), 0, W // c - 1)
        cv_ = np.clip((uv[:n, 1] // c).astype(np.int32), 0, H // c - 1)
        for k in np.argsort(score[:n], kind="stable"):
            occ[cv_[k], cu[k]] = k
        cov2_inv = np.ones((K, 2), np.float32)
        response = score.copy()
        if self.cov_from_heat and heat is not None:
            from sp_orb_slam_tpu_torch.ops.covariance import (
                covariance_reference)

            mx, mn = float(heat.max()), float(heat.min())
            heat_inv = (mx - heat) / max(mx - mn, 1e-12)
            _, ci, resp = covariance_reference(
                heat_inv, uv.astype(int), valid, radius=self.cov_radius)
            cov2_inv[:] = ci
            response[:] = resp
        return dict(uv=uv, desc=desc, valid=valid, occ_grid=occ, dust=dust,
                    cov2_inv=cov2_inv, score=score, response=response,
                    count=n)

    def __iter__(self) -> Iterator[RawFrame]:
        for i in range(len(self.entries)):
            yield self.frame(i)

    # -------------------------------------------------- writer (roundtrip)

    @staticmethod
    def save_index(root: str, stamps_ns: List[int]) -> None:
        """cam0/data.csv in the layout loadImages parses."""
        os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
        with open(os.path.join(root, "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t in stamps_ns:
                f.write(f"{t},{t}.png\n")

    @staticmethod
    def save_frame(root: str, index: int, *, uv: np.ndarray,
                   score: np.ndarray, desc: np.ndarray, dust: np.ndarray,
                   heat: Optional[np.ndarray] = None,
                   global_desc: Optional[np.ndarray] = None,
                   t_ns: Optional[int] = None, border: int = 8) -> None:
        """Write one frame in the reference's byte layout (raw <f4,
        readDepthBinary-compatible), so files go both ways."""
        fdir = os.path.join(root, "features", f"{index:06d}")
        os.makedirs(fdir, exist_ok=True)
        n = int(len(uv))
        with open(os.path.join(fdir, "size"), "w") as f:
            f.write(f"{n}\n")
        pts = np.concatenate(
            [np.asarray(uv, np.float32).reshape(n, 2),
             np.asarray(score, np.float32).reshape(n, 1)], axis=1)
        pts.astype("<f4").tofile(os.path.join(fdir, "pts.bin"))
        np.asarray(desc, np.float32).reshape(n, 256).astype("<f4").tofile(
            os.path.join(fdir, "desc_mat.bin"))
        np.asarray(dust, np.float32).astype("<f4").tofile(
            os.path.join(fdir, "dust.bin"))
        if heat is not None:
            heat = np.asarray(heat, np.float32)
            heat.astype("<f4").tofile(os.path.join(fdir, "dense_sm.bin"))
            heat[border:-border, border:-border].astype("<f4").tofile(
                os.path.join(fdir, "dense.bin"))
        if global_desc is not None:
            vdir = os.path.join(root, "vlad")
            os.makedirs(vdir, exist_ok=True)
            name = f"{t_ns}.bin" if t_ns is not None else f"{index:06d}.bin"
            gd = np.zeros(4096, np.float32)
            g = np.asarray(global_desc, np.float32).ravel()
            gd[:g.size] = g
            gd.astype("<f4").tofile(os.path.join(vdir, name))


def make_dataset(cfg: Config):
    """The loader `cfg.dataset` names, reading `cfg.data_path` / `cfg.seq`."""
    name = cfg.dataset.lower()
    # the export check runs FIRST: family-prefixed export names such as
    # "euroc_export" must not be taken by the family branches below
    if name.endswith("export"):
        root = (os.path.join(cfg.data_path, cfg.seq)
                if cfg.seq else cfg.data_path)
        # a tree with the reference's own export files (features/ blob
        # dirs or vlad/ bins) loads through the byte-layout reader; the npz
        # schema keeps its frames/ directory
        if (os.path.isdir(os.path.join(root, "features"))
                or os.path.isdir(os.path.join(root, "vlad"))):
            return ReferenceExportDataset(
                root, seq=None,
                height=cfg.camera.height, width=cfg.camera.width,
                cell=cfg.extractor.cell_size, border=cfg.extractor.border,
                max_keypoints=cfg.runtime.max_keypoints)
        return ExportDataset(root)
    if name.startswith("euroc"):
        return EurocDataset(cfg.data_path, cfg.seq)
    if name.startswith("tsukuba"):
        return TsukubaDataset(os.path.join(cfg.data_path, cfg.seq)
                              if cfg.seq else cfg.data_path)
    if name.startswith("synthetic"):
        return SyntheticDataset(cfg)
    if name.startswith("rendered"):
        # seq is the texture seed; a closed-loop trajectory by default
        from sp_orb_slam_tpu_torch.io.render import RenderedDataset

        return RenderedDataset(cfg, seed=int(cfg.seq or 0), noise_seed=0)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
