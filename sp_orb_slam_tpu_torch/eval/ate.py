"""Trajectory evaluation: the reference's evo protocol.

Reference (orb_ros/scripts/evo_euroc.py:24-62, evo_tsukuba.py): associate
estimated and ground-truth stamps, Sim(3) (scale-corrected) alignment, APE
translation mean & RMSE; a run fails when RMSE exceeds the per-dataset
threshold (1.0 m EuRoC, 100 cm Tsukuba).

The port keeps its own copy of the JAX package's eval/ate.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-stamp association (evo's associate step)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = t_gt[j - 1]
    right = t_gt[j]
    use_left = (t_est - left) < (right - t_est)
    idx = np.where(use_left, j - 1, j)
    ok = np.abs(t_gt[idx] - t_est) <= max_dt
    return np.nonzero(ok)[0], idx[ok]


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Closed-form Sim(3) aligning src -> dst (Umeyama 1991, with scale —
    evo's align with correct_scale=True)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    return s, R, t


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    n_pairs: int
    scale: float


def ate_sim3(t_est, p_est, t_gt, p_gt, max_dt: float = 0.02) -> ATEResult:
    """Sim3-aligned absolute translation error (the reference metric)."""
    i_est, i_gt = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(i_est) < 3:
        return ATEResult(float("inf"), float("inf"), float("inf"), 0, 1.0)
    src = np.asarray(p_est)[i_est]
    dst = np.asarray(p_gt)[i_gt]
    s, R, t = umeyama_sim3(src, dst)
    aligned = (s * (R @ src.T)).T + t
    err = np.linalg.norm(aligned - dst, axis=1)
    return ATEResult(float(np.sqrt((err ** 2).mean())), float(err.mean()),
                     float(np.median(err)), len(err), s)
