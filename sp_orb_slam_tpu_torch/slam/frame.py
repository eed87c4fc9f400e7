"""Per-frame data container.

The port of the JAX package's slam/frame.py: fixed-capacity arrays with
validity masks.  The descriptors, dust map and occupancy grid (and, for the
heat coarse tracker, the full-resolution heat map) stay on the system's
device for the tracking kernels; the small host mirrors (keypoint
coords, covariance, counts) come back in one packed copy per frame.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.extractor import Features


def orthonormalized_pose(Tcw: np.ndarray) -> np.ndarray:
    """Project the rotation block of an SE3 onto SO(3) (polar
    decomposition, R <- U V^T) and return a clean float32 4x4 — the
    counterpart of g2o's quaternion-backed SE3 storage: float32 exp-map
    product chains otherwise accumulate shear that every transpose-based
    inverse downstream amplifies."""
    T = np.asarray(Tcw, np.float64)
    U, _, Vt = np.linalg.svd(T[:3, :3])
    R = U @ Vt
    if np.linalg.det(R) < 0:  # keep a proper rotation
        R = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.astype(np.float32)
    out[:3, 3] = T[:3, 3].astype(np.float32)
    return out


@dataclass
class FrameData:
    """One frame's features + pose + map bindings (capacity K)."""

    frame_id: int
    timestamp: float
    # host mirrors
    uv: np.ndarray            # (K, 2) float32
    score: np.ndarray         # (K,)
    response: np.ndarray      # (K,)
    valid: np.ndarray         # (K,) bool
    cov2_inv: np.ndarray      # (K, 2)
    occ_grid: np.ndarray      # (hc, wc) int32
    count: int
    # device residents (torch tensors)
    desc_dev: torch.Tensor    # (K, 256)
    dust_dev: torch.Tensor    # (hc, wc)
    occ_grid_dev: torch.Tensor  # (hc, wc)
    # pose & bindings
    Tcw: Optional[np.ndarray] = None          # (4, 4) float32, None until set
    mp_ids: np.ndarray = None                 # (K,) int64, -1 = unbound
    outlier: np.ndarray = None                # (K,) bool
    ref_kf: int = -1
    # place-recognition global descriptor, when the dataset provides one
    global_desc: Optional[np.ndarray] = None
    # (H, W) on the device: the heat coarse tracker's map, when extracted
    heat_dev: Optional[torch.Tensor] = None

    def __post_init__(self):
        K = self.uv.shape[0]
        if self.mp_ids is None:
            self.mp_ids = np.full(K, -1, np.int64)
        if self.outlier is None:
            self.outlier = np.zeros(K, bool)

    # lazily fetched host descriptor copy (paid only when the frame becomes
    # a keyframe)
    _desc_host: Optional[np.ndarray] = None

    @property
    def desc_host(self) -> np.ndarray:
        if self._desc_host is None:
            self._desc_host = self.desc_dev.cpu().numpy()
        return self._desc_host

    @property
    def K(self) -> int:
        return self.uv.shape[0]

    def set_pose(self, Tcw: np.ndarray) -> None:
        self.Tcw = orthonormalized_pose(Tcw)

    @property
    def Rcw(self) -> np.ndarray:
        return self.Tcw[:3, :3]

    @property
    def tcw(self) -> np.ndarray:
        return self.Tcw[:3, 3]

    @property
    def Ow(self) -> np.ndarray:
        return -self.Rcw.T @ self.tcw

    def clone_bindings(self) -> "FrameData":
        """Shallow copy with independent binding arrays (mLastFrame copy)."""
        f = copy.copy(self)
        f.mp_ids = self.mp_ids.copy()
        f.outlier = self.outlier.copy()
        if self.Tcw is not None:
            f.Tcw = self.Tcw.copy()
        return f


def frame_from_features(feats: Features, b: int, frame_id: int,
                        timestamp: float, host: dict) -> FrameData:
    """A FrameData from stream `b` of a batched Features; `host` is the
    packed host copy (TrackingKernels.fetch_features_host)."""
    return FrameData(
        frame_id=frame_id, timestamp=timestamp, uv=host["uv"],
        score=host["score"], response=host["response"],
        valid=host["valid"], cov2_inv=host["cov2_inv"],
        occ_grid=host["occ_grid"], count=int(host["count"]),
        desc_dev=feats.desc[b], dust_dev=feats.dense_dust[b],
        occ_grid_dev=feats.occ_grid[b],
        heat_dev=feats.heat[b] if feats.heat is not None else None)
