"""Bundle adjustment as batched Schur-complement LM on the device.

The port of the JAX package's optim/ba.py:
- local BA (Optimizer::LocalBundleAdjustment): mono edges weighted by
  diag(cov2_inv) with Huber sqrt(5.991); 5 iterations, then edges with
  chi2 > 5.991 or non-positive depth go inactive and the robust kernel is
  dropped for 10 more; the final classification marks observations for
  erasure;
- plain / global BA: one phase, optional Huber.

The point blocks are eliminated with a dense-capacity Schur complement:
the camera-point coupling blocks live in a (P, C, 6, 3) tensor, so the
reduced camera system S = Hcc - W Hpp^-1 W^T is two batched products and
one (6C, 6C) solve.  Fixed cameras get zero rows/columns in S and an
identity diagonal block.  Block sums are `index_add_` scatters.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sp_orb_slam_tpu_torch.geometry import se3
from sp_orb_slam_tpu_torch.optim import lm
from sp_orb_slam_tpu_torch.optim.pose import _proj_jacobian

CHI2_MONO = 5.991
HUBER_MONO = math.sqrt(5.991)


class BAResult(NamedTuple):
    poses: torch.Tensor     # (C, 4, 4) optimized Tcw
    points: torch.Tensor    # (P, 3) optimized world points
    bad_obs: torch.Tensor   # (O,) observations failing the final gate
    chi2: torch.Tensor      # (O,) final per-observation chi2


def _evaluate(poses, points, obs_cam, obs_pt, obs_uv, obs_w, K):
    Tcw = poses[obs_cam]                       # (O, 4, 4)
    pc = (Tcw[:, :3, :3] @ points[obs_pt][..., None])[..., 0] + Tcw[:, :3, 3]
    z = pc[:, 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    uv = torch.stack([K[0] * pc[:, 0] / zsafe + K[2],
                      K[1] * pc[:, 1] / zsafe + K[3]], -1)
    r = obs_uv - uv
    return r, (r * r * obs_w).sum(-1), pc, z


def _scatter(n: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n,) + src.shape[1:], dtype=src.dtype,
                       device=src.device).index_add_(0, index, src)


def _build_system(poses, points, obs_cam, obs_pt, obs_uv, obs_w, K, active,
                  huber_delta, use_huber, C, P):
    r, chi2, pc, _ = _evaluate(poses, points, obs_cam, obs_pt, obs_uv,
                               obs_w, K)
    w_rob = (lm.huber_weight(chi2, huber_delta) if use_huber
             else torch.ones_like(chi2))
    W = obs_w * torch.where(active, w_rob, 0.0)[:, None]   # (O, 2)

    fx, fy = K[0], K[1]
    Jc = -_proj_jacobian(pc, fx, fy)           # (O, 2, 6) d r / d xi_cam
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    invz = 1.0 / z
    invz2 = invz * invz
    zeros = torch.zeros_like(x)
    J_pc = torch.stack([torch.stack([fx * invz, zeros, -fx * x * invz2], -1),
                        torch.stack([zeros, fy * invz, -fy * y * invz2], -1)],
                       -2)                     # (O, 2, 3)
    Jp = -(J_pc @ poses[obs_cam][:, :3, :3])   # (O, 2, 3) d r / d X_w

    JcW = Jc * W[..., None]
    JpW = Jp * W[..., None]
    Hcc = _scatter(C, obs_cam, JcW.transpose(1, 2) @ Jc)
    Hpp = _scatter(P, obs_pt, JpW.transpose(1, 2) @ Jp)
    bc = _scatter(C, obs_cam, -(JcW.transpose(1, 2) @ r[..., None])[..., 0])
    bp = _scatter(P, obs_pt, -(JpW.transpose(1, 2) @ r[..., None])[..., 0])
    Wcp = _scatter(P * C, obs_pt.long() * C + obs_cam,
                   JcW.transpose(1, 2) @ Jp).view(P, C, 6, 3)
    rho = lm.huber_rho(chi2, huber_delta) if use_huber else chi2
    cost = torch.where(active, rho, 0.0).sum()
    return Hcc, Hpp, bc, bp, Wcp, cost


def _schur_step(Hcc, Hpp, bc, bp, Wcp, lam, fixed, C, P):
    dev, dt = Hcc.device, Hcc.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hpp_inv, _ = torch.linalg.inv_ex(Hpp + lam * eye3)          # (P, 3, 3)
    T = Wcp @ Hpp_inv[:, None]                                  # (P, C, 6, 3)
    Tf = T.reshape(P, C * 6, 3)
    S = -torch.einsum("pix,pjx->ij", Tf, Wcp.reshape(P, C * 6, 3))
    free = (~fixed).to(dt)
    diag = torch.where(fixed[:, None, None], eye6, Hcc + lam * eye6)
    S = S.view(C, 6, C, 6) * free[:, None, None, None] * free[None, None, :,
                                                               None]
    ci = torch.arange(C, device=dev)
    S[ci, :, ci, :] += diag
    b_red = (bc - torch.einsum("pix,px->i", Tf, bp).view(C, 6)) * free[:, None]
    dc, _ = torch.linalg.solve_ex(S.reshape(C * 6, C * 6),
                                  b_red.reshape(C * 6, 1))
    dc = dc.view(C, 6) * free[:, None]
    # back-substitute points: dp = Hpp^-1 (bp - sum_c Wcp^T dc)
    rhs = bp - torch.einsum("pcax,ca->px", Wcp, dc)
    dp = (Hpp_inv @ rhs[..., None])[..., 0]
    return dc, dp


def _lm_phase(poses, points, obs_cam, obs_pt, obs_uv, obs_w, K, active,
              fixed, pt_valid, *, iters, use_huber, huber_delta=HUBER_MONO):
    C, P = poses.shape[0], points.shape[0]

    def cost_of(po, pt):
        _, chi2, _, _ = _evaluate(po, pt, obs_cam, obs_pt, obs_uv, obs_w, K)
        rho = lm.huber_rho(chi2, huber_delta) if use_huber else chi2
        return torch.where(active, rho, 0.0).sum()

    Hcc0 = _build_system(poses, points, obs_cam, obs_pt, obs_uv, obs_w, K,
                         active, huber_delta, use_huber, C, P)[0]
    lam = (lm.TAU * torch.diagonal(Hcc0, dim1=-2, dim2=-1).max()
           ).clamp_min(1e-10)
    nu = torch.full_like(lam, 2.0)
    cost = cost_of(poses, points)
    for _ in range(iters):
        Hcc, Hpp, bc, bp, Wcp, _ = _build_system(
            poses, points, obs_cam, obs_pt, obs_uv, obs_w, K, active,
            huber_delta, use_huber, C, P)
        dc, dp = _schur_step(Hcc, Hpp, bc, bp, Wcp, lam, fixed, C, P)
        dp = dp * pt_valid[:, None]
        new_poses = torch.where(fixed[:, None, None], poses,
                                se3.se3_exp(dc) @ poses)
        new_points = points + dp
        cost_new = cost_of(new_poses, new_points)
        denom = (dc * (lam * dc + bc)).sum() + (dp * (lam * dp + bp)).sum()
        rho = (cost - cost_new) / torch.where(denom.abs() < 1e-12, 1e-12,
                                              denom)
        # a relative decrease: the free scale gauge of a mono BA would let
        # float32 noise random-walk the map under a plain cost_new < cost
        accept = (cost_new < cost * (1.0 - 1e-5)) & torch.isfinite(cost_new)
        lam, nu = lm.lm_update(accept, rho, lam, nu)
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        cost = torch.where(accept, cost_new, cost)
    return poses, points


def bundle_adjust(poses, fixed, points, pt_valid, obs_cam, obs_pt, obs_uv,
                  obs_w, obs_valid, K, *, iters1: int = 5, iters2: int = 10,
                  two_phase: bool = True, robust: bool = True) -> BAResult:
    """Local BA (two_phase) or plain BA (one phase, optional robust).

    poses (C, 4, 4) Tcw; fixed (C,) bool; points (P, 3); pt_valid (P,);
    obs_* (O,) with obs_w (O, 2) diagonal information, obs_cam / obs_pt
    int64 in range (invalid observations carry in-range indices);
    K = [fx, fy, cx, cy]."""
    active = obs_valid
    poses, points = _lm_phase(poses, points, obs_cam, obs_pt, obs_uv, obs_w,
                              K, active, fixed, pt_valid, iters=iters1,
                              use_huber=robust)
    if two_phase:
        _, chi2, _, z = _evaluate(poses, points, obs_cam, obs_pt, obs_uv,
                                  obs_w, K)
        active = active & (chi2 <= CHI2_MONO) & (z > 0)
        poses, points = _lm_phase(poses, points, obs_cam, obs_pt, obs_uv,
                                  obs_w, K, active, fixed, pt_valid,
                                  iters=iters2, use_huber=False)
    _, chi2, _, z = _evaluate(poses, points, obs_cam, obs_pt, obs_uv, obs_w,
                              K)
    bad = obs_valid & ((chi2 > CHI2_MONO) | (z <= 0))
    return BAResult(poses, points, bad, chi2)
