"""Pose-only optimizers: covariance-weighted reprojection and direct dustbin
alignment, as fixed-iteration LM.

The port of the JAX package's optim/pose.py:
- `pose_optimization` (Optimizer::PoseOptimization): 4 rounds x 10 LM
  iterations, each round restarting from the initial pose on the current
  inlier set; information diag(cov2_inv); Huber sqrt(5.991) in rounds 0-2;
  every edge reclassified by chi2 > 5.991 between rounds;
- `pose_optimization_post` (PoseOptimizationDustPost): 10 Huber
  iterations, reclassify at chi2 > 7.378, 10 more non-robust iterations;
- `pose_optimization_dust` (PoseOptimizationDust): 1-d residual = bilinear
  sample of the 1/8 dustbin map at the projection (fx/8, (cx-3.5)/8),
  Huber 0.9, 40 iterations, edges leaving the image latched off;
- `pose_optimization_heat` (PoseOptimizationHeat, optimizer_dust.cpp:
  415-522): the same direct alignment on the full-resolution heat map with
  the full-resolution intrinsics and the 0.02 chi2 inlier gate.

`pose_optimization` also takes a batch of initial poses (S, 4, 4) against
one set of edges: the relocalization multi-start fan.  The round loop is a
Python loop (its Huber switch is static), the LM loop runs its fixed count
with `torch.where` masks and never reads back.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sp_orb_slam_tpu_torch.geometry import se3
from sp_orb_slam_tpu_torch.optim import lm

CHI2_MONO = 5.991
HUBER_MONO = math.sqrt(5.991)


def _proj_jacobian(pc: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(u, v)/d xi for xi = [omega, upsilon], per point: pc (..., N, 3)
    camera-frame points -> (..., N, 2, 6) (of the projection)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    invz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    invz2 = invz * invz
    zeros = torch.zeros_like(x)
    J_pc = torch.stack([torch.stack([fx * invz, zeros, -fx * x * invz2], -1),
                        torch.stack([zeros, fy * invz, -fy * y * invz2], -1)],
                       -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    return J_pc @ torch.cat([-se3.hat(pc), eye], -1)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor       # (..., 4, 4)
    inlier: torch.Tensor    # (..., N) bool (active & chi2 below gate)
    n_inlier: torch.Tensor  # (...) int32
    chi2: torch.Tensor      # (..., N) final chi2 per edge


def _reproj_chi2(Tcw, Xw, obs, w_info, K):
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    pc = Xw @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]
    # sign-preserving depth clamp: z == 0 would NaN-poison the cost
    z = pc[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    uv = torch.stack([fx * pc[..., 0] / zsafe + cx,
                      fy * pc[..., 1] / zsafe + cy], -1)
    r = obs - uv
    return (r * r * w_info).sum(-1), r, pc


def _normal_eq(J: torch.Tensor, W: torch.Tensor, r: torch.Tensor):
    """H = sum_n J^T diag(W) J and b = -sum_n J^T diag(W) r for J (..., N,
    m, 6), W and r (..., N, m)."""
    Jf = J.flatten(-3, -2)                     # (..., N m, 6)
    JW = Jf * W.flatten(-2)[..., None]
    H = JW.transpose(-1, -2) @ Jf
    b = -(JW.transpose(-1, -2) @ r.flatten(-2)[..., None])[..., 0]
    return H, b


def _lm_reproj(Tcw0, Xw, obs, w_info, K, active, *, iters: int,
               use_huber: bool, huber_delta: float = HUBER_MONO):
    """One g2o optimize(iters) call on the active reprojection edges."""
    fx, fy = K[0], K[1]

    def cost_of(chi2):
        rho = lm.huber_rho(chi2, huber_delta) if use_huber else chi2
        return torch.where(active, rho, 0.0).sum(-1)

    def system(Tcw):
        chi2, r, pc = _reproj_chi2(Tcw, Xw, obs, w_info, K)
        w_rob = (lm.huber_weight(chi2, huber_delta) if use_huber
                 else torch.ones_like(chi2))
        w = torch.where(active, w_rob, 0.0)
        J = -_proj_jacobian(pc, fx, fy)  # residual = obs - proj
        H, b = _normal_eq(J, w_info * w[..., None], r)
        return H, b, cost_of(chi2)

    H0, _, cost = system(Tcw0)
    lam = lm.lm_init_lambda(H0)
    nu = torch.full_like(lam, 2.0)
    Tcw = Tcw0
    for _ in range(iters):
        H, b, _ = system(Tcw)
        dx = lm.solve_damped(H, b, lam)
        T_new = se3.se3_exp(dx) @ Tcw
        cost_new = cost_of(_reproj_chi2(T_new, Xw, obs, w_info, K)[0])
        rho = lm.gain_ratio(cost, cost_new, dx, b, lam)
        ok = (cost_new < cost) & torch.isfinite(cost_new)
        lam, nu = lm.lm_update(ok, rho, lam, nu)
        Tcw = torch.where(ok[..., None, None], T_new, Tcw)
        cost = torch.where(ok, cost_new, cost)
    return Tcw


def pose_optimization(Tcw0: torch.Tensor, Xw: torch.Tensor,
                      obs: torch.Tensor, cov2_inv: torch.Tensor,
                      valid: torch.Tensor, K: torch.Tensor, *,
                      rounds: int = 4, iters: int = 10) -> PoseOptResult:
    """Optimizer::PoseOptimization.  Tcw0 (4, 4) or a fan (S, 4, 4); Xw
    (N, 3) world points, obs (N, 2) keypoint pixels, cov2_inv (N, 2)
    diagonal information, valid (N,) edge mask, K = [fx, fy, cx, cy]."""
    outlier = torch.zeros_like(valid)
    Tcw = Tcw0
    for it in range(rounds):
        # the robust kernel is removed after round it == 2
        Tcw = _lm_reproj(Tcw0, Xw, obs, cov2_inv, K, valid & ~outlier,
                         iters=iters, use_huber=it <= 2)
        chi2 = _reproj_chi2(Tcw, Xw, obs, cov2_inv, K)[0]
        outlier = valid & (chi2 > CHI2_MONO)
    chi2 = _reproj_chi2(Tcw, Xw, obs, cov2_inv, K)[0]
    inlier = valid & ~outlier
    return PoseOptResult(Tcw, inlier, inlier.sum(-1, dtype=torch.int32),
                         chi2)


def pose_optimization_post(Tcw0, Xw, obs, cov2_inv, valid, K, *,
                           iters: int = 10) -> PoseOptResult:
    """Optimizer::PoseOptimizationDustPost: 10 Huber iterations from Tcw0,
    reclassify at chi2 > 7.378, 10 more non-robust iterations from there."""
    T1 = _lm_reproj(Tcw0, Xw, obs, cov2_inv, K, valid, iters=iters,
                    use_huber=True)
    chi2 = _reproj_chi2(T1, Xw, obs, cov2_inv, K)[0]
    active = valid & ~(valid & (chi2 > 7.378))
    T2 = _lm_reproj(T1, Xw, obs, cov2_inv, K, active, iters=iters,
                    use_huber=False)
    chi2f = _reproj_chi2(T2, Xw, obs, cov2_inv, K)[0]
    return PoseOptResult(T2, active, active.sum(-1, dtype=torch.int32),
                         chi2f)


def _sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """getPixelValue semantics: floor-based bilinear interpolation with the
    corner clamped to [0, w-2] x [0, h-2] (callers mask out-of-image)."""
    h, w = img.shape
    x0 = u.floor().clamp(-1.0, float(w)).long().clamp(0, w - 2)
    y0 = v.floor().clamp(-1.0, float(h)).long().clamp(0, h - 2)
    xx = u - x0
    yy = v - y0
    return ((1 - xx) * (1 - yy) * img[y0, x0] + xx * (1 - yy) * img[y0, x0 + 1]
            + (1 - xx) * yy * img[y0 + 1, x0] + xx * yy * img[y0 + 1, x0 + 1])


class DustResult(NamedTuple):
    Tcw: torch.Tensor
    inlier: torch.Tensor    # (N,) active & chi2 <= chi2_inlier
    n_inlier: torch.Tensor
    proj_uv: torch.Tensor   # (N, 2) projections at the final pose, on the
    #                         aligned map's grid (1/8 cells or pixels)


def _direct_alignment(Tcw0, Xw, valid, img, fx, fy, cx, cy, *, iters,
                      huber_delta, chi2_inlier) -> DustResult:
    """Direct alignment of the points' projections on a map `img` (h, w)
    whose value is the residual (types_dust_tracking.cpp): bilinear sample
    at the projection, central-difference image gradient through the same
    sample, Huber weight, edges leaving the image (border 1) or going
    behind the camera latched off."""
    h, w = img.shape

    def evaluate(Tcw, alive):
        pc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        # in-image test with border 1 (types_dust_tracking.cpp:36-41)
        ok = (alive & (z > 0.0) & (u >= 1.0) & (u + 2.0 < w) & (v >= 1.0)
              & (v + 2.0 < h))
        err = torch.where(ok, _sample_bilinear(img, u, v), 0.0)
        return err, u, v, pc, ok

    def cost_of(err, ok):
        chi2 = err * err
        return torch.where(ok, lm.huber_rho(chi2, huber_delta), 0.0).sum()

    def system(Tcw, alive):
        err, u, v, pc, ok = evaluate(Tcw, alive)
        w_rob = torch.where(ok, lm.huber_weight(err * err, huber_delta), 0.0)
        # central-difference image gradient (types_dust_tracking.cpp:131-137)
        gu = (_sample_bilinear(img, u + 1.0, v)
              - _sample_bilinear(img, u - 1.0, v)) / 2.0
        gv = (_sample_bilinear(img, u, v + 1.0)
              - _sample_bilinear(img, u, v - 1.0)) / 2.0
        Jp = _proj_jacobian(pc, fx, fy)
        J = gu[:, None] * Jp[:, 0, :] + gv[:, None] * Jp[:, 1, :]  # (N, 6)
        JW = J * w_rob[:, None]
        return JW.T @ J, -(JW.T @ err), cost_of(err, ok), ok

    # latch the initially-invalid edges (computeError's setLevel(1))
    H0, _, cost, alive = system(Tcw0, valid)
    lam = lm.lm_init_lambda(H0)
    nu = torch.full_like(lam, 2.0)
    Tcw = Tcw0
    for _ in range(iters):
        H, b, _, ok = system(Tcw, alive)
        alive = alive & ok  # once out, stays out
        dx = lm.solve_damped(H, b, lam)
        T_new = se3.se3_exp(dx) @ Tcw
        err_n, _, _, _, ok_new = evaluate(T_new, alive)
        cost_new = cost_of(err_n, ok_new)
        rho = lm.gain_ratio(cost, cost_new, dx, b, lam)
        # step-sanity guard: the masked cost rewards flinging points out of
        # the image, so a wild solver step can score 0; real steps are tiny
        sane = (dx * dx).sum() < 1e6
        accept = sane & (cost_new < cost) & torch.isfinite(cost_new)
        lam, nu = lm.lm_update(accept, rho, lam, nu)
        Tcw = torch.where(accept, T_new, Tcw)
        alive = torch.where(accept, alive & ok_new, alive)
        cost = torch.where(accept, cost_new, cost)

    err, u, v, _, ok = evaluate(Tcw, alive)
    inlier = valid & alive & ok & (err * err <= chi2_inlier)
    return DustResult(Tcw, inlier, inlier.sum(dtype=torch.int32),
                      torch.stack([u, v], -1))


def pose_optimization_dust(Tcw0: torch.Tensor, Xw: torch.Tensor,
                           valid: torch.Tensor, dust: torch.Tensor,
                           K_full: torch.Tensor, *, iters: int = 40,
                           huber_delta: float = 0.9,
                           chi2_inlier: float = 0.9) -> DustResult:
    """Optimizer::PoseOptimizationDust.  dust (hc, wc) dustbin probability
    map; K_full the full-resolution [fx, fy, cx, cy], scaled to the 1/8
    grid inside (optimizer_dust.cpp:223-226)."""
    return _direct_alignment(
        Tcw0, Xw, valid, dust, K_full[0] / 8.0, K_full[1] / 8.0,
        (K_full[2] - 3.5) / 8.0, (K_full[3] - 3.5) / 8.0, iters=iters,
        huber_delta=huber_delta, chi2_inlier=chi2_inlier)


def pose_optimization_heat(Tcw0: torch.Tensor, Xw: torch.Tensor,
                           valid: torch.Tensor, heat: torch.Tensor,
                           K_full: torch.Tensor, *, iters: int = 40,
                           huber_delta: float = 0.9,
                           chi2_inlier: float = 0.02) -> DustResult:
    """Optimizer::PoseOptimizationHeat: the dust alignment on the
    normalised full-resolution heat map (H, W) with the full-resolution
    intrinsics; `proj_uv` is in full-resolution pixels."""
    return _direct_alignment(
        Tcw0, Xw, valid, heat, K_full[0], K_full[1], K_full[2], K_full[3],
        iters=iters, huber_delta=huber_delta, chi2_inlier=chi2_inlier)
