"""Batched DLT triangulation + the reference's acceptance gates.

The port of the JAX package's geometry/triangulation.py (Initializer::
Triangulate and the gate chain of LocalMapping::CreateNewMapPointsOverride):
parallax window, positive depth in both views, covariance-weighted
chi^2 <= 5.991 reprojection in both views.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def svd(A: torch.Tensor, full_matrices: bool = True):
    """torch.linalg.svd that, like LAPACK under JAX, answers a matrix with
    non-finite entries with NaN factors instead of raising: such a matrix
    is factored as zeros and its factors are set to NaN, per batch
    element.  (Stages that run both branches of a JAX `lax.cond` factor
    the unselected branch's matrices too.)"""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, A),
                                full_matrices=full_matrices)
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None, None], nan, U),
            torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vh))


def triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor) -> torch.Tensor:
    """DLT: projection matrices P (..., 3, 4), coords (..., N, 2) ->
    (..., N, 3), from the null vector of each point's 4x4 design matrix
    (batched SVD; the null vector's sign cancels in the division)."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    A = torch.stack([uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
                     uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
                     uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
                     uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], -2)
    x = svd(A)[2][..., 3, :]
    w = torch.where(x[..., 3].abs() < 1e-12, 1e-12, x[..., 3])
    return x[..., :3] / w[..., None]


def depth_and_tau(X: torch.Tensor, O_self: torch.Tensor,
                  O_other: torch.Tensor, px_error_angle) -> tuple:
    """Along-ray depth of X from O_self and its 1-observation uncertainty
    (SVO computeTau): perturb the ray in the other camera by the pixel-noise
    angle and intersect with the baseline triangle; degenerate triangles
    get tau = +inf.  Returns (z, tau)."""
    t = O_other - O_self
    t_norm = torch.linalg.vector_norm(t)
    f = X - O_self
    z = torch.linalg.vector_norm(f, dim=-1)
    f_unit = f / z.clamp_min(1e-9)[:, None]
    a = X - O_other
    a_norm = torch.linalg.vector_norm(a, dim=-1).clamp_min(1e-9)
    tn = t_norm.clamp_min(1e-9)
    alpha = torch.arccos((f_unit @ t / tn).clamp(-1.0, 1.0))
    beta = torch.arccos((-(a @ t) / (a_norm * tn)).clamp(-1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma = math.pi - alpha - beta_plus
    sin_g = torch.sin(gamma)
    degenerate = sin_g <= 1e-6
    z_plus = t_norm * torch.sin(beta_plus) / torch.where(degenerate, 1.0,
                                                         sin_g)
    tau = torch.where(degenerate, math.inf, (z_plus - z).abs())
    return z, tau


class TriGates(NamedTuple):
    good: torch.Tensor          # (N,) all gates passed
    rej_parallax: torch.Tensor  # per-gate masks, for the reference's counters
    rej_depth: torch.Tensor
    rej_reproj: torch.Tensor


def triangulation_gates(X: torch.Tensor, Tcw1, Tcw2, K, uv1, uv2,
                        cov2_inv1, cov2_inv2, valid) -> TriGates:
    """The gate chain of local_mapper.cpp:665-778 (batched)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    R1, t1 = Tcw1[:3, :3], Tcw1[:3, 3]
    R2, t2 = Tcw2[:3, :3], Tcw2[:3, 3]
    O1 = -R1.T @ t1
    O2 = -R2.T @ t2

    def ray(uv, R):
        xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                          torch.ones_like(uv[:, 0])], -1)
        return xn @ R

    ray1, ray2 = ray(uv1, R1), ray(uv2, R2)
    cos_par = (ray1 * ray2).sum(-1) / (
        torch.linalg.vector_norm(ray1, dim=-1)
        * torch.linalg.vector_norm(ray2, dim=-1))
    par_ok = (cos_par > 0) & (cos_par < 0.9998)

    pc1 = X @ R1.T + t1
    pc2 = X @ R2.T + t2
    depth_ok = (pc1[:, 2] > 0) & (pc2[:, 2] > 0)

    def reproj_chi2(pc, uv, w):
        u = fx * pc[:, 0] / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        return (u - uv[:, 0]) ** 2 * w[:, 0] + (v - uv[:, 1]) ** 2 * w[:, 1]

    reproj_ok = ((reproj_chi2(pc1, uv1, cov2_inv1) <= 5.991)
                 & (reproj_chi2(pc2, uv2, cov2_inv2) <= 5.991))
    dist_ok = ((torch.linalg.vector_norm(X - O1, dim=-1) > 0)
               & (torch.linalg.vector_norm(X - O2, dim=-1) > 0))
    good = valid & par_ok & depth_ok & reproj_ok & dist_ok
    return TriGates(good, valid & ~par_ok, valid & par_ok & ~depth_ok,
                    valid & par_ok & depth_ok & ~reproj_ok)
