"""The parts of the JAX package's io/dataset.py that the port's rails need:
the loader frame record, the trajectory generators, the synthetic
injected-feature dataset (the deterministic end-to-end rail: a procedural
3D scene with persistent descriptors, projected per frame with noise) and
the synthetic / rendered branches of `make_dataset`.

The EuRoC, Tsukuba and export loaders are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

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


def make_dataset(cfg: Config):
    """The synthetic and rendered rails by `cfg.dataset`."""
    name = cfg.dataset.lower()
    if name.startswith("synthetic"):
        return SyntheticDataset(cfg)
    if name.startswith("rendered"):
        # seq is the texture seed; a closed-loop trajectory by default
        from sp_orb_slam_tpu_torch.io.render import RenderedDataset

        return RenderedDataset(cfg, seed=int(cfg.seq or 0), noise_seed=0)
    raise ValueError(f"dataset {cfg.dataset!r} is not ported (synthetic, "
                     f"rendered)")
