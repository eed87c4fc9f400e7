"""Sim(3) estimation and optimization for loop closing.

The port of the JAX package's optim/sim3.py (Sim3Solver,
src/mapping/sim3_solver.{h,cpp}; Optimizer::OptimizeSim3 and
OptimizeEssentialGraph, src/mapping/optimizer.cpp:776-1254):
- the group operations in g2o's sim3.h conventions, xi = [omega, upsilon,
  sigma], every function broadcasting over leading batch dimensions;
- Horn's closed form inside RANSAC: all hypotheses score as one batched
  computation, with the sample positions `draws` an argument (the caller
  owns the random stream, as in geometry/twoview.initialize);
- OptimizeSim3: paired forward/backward projection edges, Huber sqrt(10),
  5 LM iterations -> prune chi2 > 10 -> `iters` more;
- the Sim3 pose graph: dense 7N normal equations with per-edge Jacobians
  from `torch.func.jacfwd` under `torch.func.vmap`.

Everything is float32 with TF32 off (utils/precision.full_f32) and runs
on the device of its inputs; the LM loops are Python loops over
`torch.where` masks and read nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from sp_orb_slam_tpu_torch.geometry import se3
from sp_orb_slam_tpu_torch.geometry.triangulation import svd
from sp_orb_slam_tpu_torch.optim import lm
from sp_orb_slam_tpu_torch.utils.precision import full_f32

_EPS = 1e-8


def _where(cond, a, b):
    """torch.where with Python-number branches made tensors of the other
    branch's dtype: under torch.func.jacfwd a number branch gives a float64
    tangent."""
    like = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Sim(3) exp/log (g2o sim3.h conventions: xi = [omega, upsilon, sigma])
# ---------------------------------------------------------------------------


def _sim3_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 'V' matrix W with t = W upsilon (g2o sim3.h):
    (..., 3), (...) -> (..., 3, 3)."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    Om = se3.hat(omega)
    Om2 = Om @ Om
    small_sigma = sigma.abs() < 1e-5
    small_theta = theta < 1e-5

    C = _where(small_sigma, 1.0,
               (s - 1.0) / _where(small_sigma, 1.0, sigma))

    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma * sigma

    A = _where(
        small_sigma,
        _where(small_theta, 0.5, (1.0 - torch.cos(theta)) / theta2),
        _where(
            small_theta,
            ((sigma - 1.0) * s + 1.0)
            / _where(small_sigma, 1.0, sigma * sigma),
            (a * sigma + (1.0 - b) * theta) / (theta * c)))
    B = _where(
        small_sigma,
        _where(small_theta, 1.0 / 6.0,
               (theta - torch.sin(theta)) / (theta2 * theta)),
        _where(
            small_theta,
            ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0)
            / _where(small_sigma, 1.0, sigma * sigma * sigma),
            (C - ((b - 1.0) * sigma + a * theta) / c) / theta2))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return (A[..., None, None] * Om + B[..., None, None] * Om2
            + C[..., None, None] * eye)


def sim3_exp(xi: torch.Tensor):
    """xi (..., 7) = [omega, upsilon, sigma] -> (R, t, s)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_exp(omega)
    s = torch.exp(sigma)
    t = (_sim3_W(omega, sigma) @ upsilon[..., None])[..., 0]
    return R, t, s


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor):
    """(R (..., 3, 3), t (..., 3), s (...)) -> xi (..., 7)."""
    omega = se3.so3_log(R)
    sigma = torch.log(s)
    # W^-1 t by the inverse: torch.linalg.solve_ex's tangents are wrong
    # under torch.func.vmap of jacfwd (samples mix), inv_ex's are right
    Winv, _ = torch.linalg.inv_ex(_sim3_W(omega, sigma))
    upsilon = (Winv @ t[..., None])[..., 0]
    return torch.cat([omega, upsilon, sigma[..., None]], -1)


def sim3_mul(A, B):
    """(R, t, s) composition: A * B."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    return (Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta,
            sa * sb)


def sim3_inverse(S):
    R, t, s = S
    Rinv = R.transpose(-1, -2)
    sinv = 1.0 / s
    return Rinv, -sinv[..., None] * (Rinv @ t[..., None])[..., 0], sinv


# ---------------------------------------------------------------------------
# Horn closed-form + RANSAC (Sim3Solver)
# ---------------------------------------------------------------------------


def sim3_horn(p1: torch.Tensor, p2: torch.Tensor):
    """Closed-form Sim3 aligning p1 -> p2 from (..., N, 3) correspondences
    (Horn 1987 via SVD, with the reference's non-symmetric scale).  A
    sample that repeats a correspondence gives a degenerate but finite
    matrix; `svd` answers a non-finite one with NaN factors."""
    c1 = p1.mean(-2)
    c2 = p2.mean(-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    with full_f32():
        M = q2.transpose(-1, -2) @ q1
        U, _, Vt = svd(M)
        d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
        S = torch.ones(d.shape + (3,), dtype=p1.dtype, device=p1.device)
        S = torch.cat([S[..., :2], d[..., None]], -1)
        R = (U * S[..., None, :]) @ Vt
        # reference (non-fixed-scale): s = sum(q2 . R q1) / sum(|q1|^2)
        s = ((q2 * (q1 @ R.transpose(-1, -2))).sum((-1, -2))
             / (q1 * q1).sum((-1, -2)).clamp_min(1e-12))
        t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return R, t, s


class Sim3RansacResult(NamedTuple):
    ok: torch.Tensor         # () bool
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    s: torch.Tensor          # ()
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _project(X: torch.Tensor, K_intr: torch.Tensor) -> torch.Tensor:
    z = _where(X[..., 2].abs() < 1e-9, 1e-9, X[..., 2])
    return torch.stack([K_intr[0] * X[..., 0] / z + K_intr[2],
                        K_intr[1] * X[..., 1] / z + K_intr[3]], -1)


def sim3_ransac(X1, X2, uv1, uv2, valid, K_intr, draws, *,
                min_inliers: int = 20, chi2_th: float = 9.210):
    """Sim3Solver RANSAC: X1/X2 (N, 3) camera-frame points of KF1/KF2 for
    matched pairs, uv1/uv2 their observed pixels; inlier = both-way
    reprojection chi2 below 9.210 (sim3_solver.cpp mvnMaxError).
    `draws` (iters, 3) are sample positions in [0, n_valid) over the
    valid pairs taken in order (a stable sort puts them first)."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    sets = order[draws.to(device=X1.device, dtype=torch.long)]  # (iters, 3)

    def score(R, t, s):
        # S12 applied to X2 and S21 applied to X1, for (..., ) hypotheses
        X2_in_1 = ((1.0 / s)[..., None, None]
                   * ((X2 - t[..., None, :]) @ R))
        X1_in_2 = (s[..., None, None] * (X1 @ R.transpose(-1, -2))
                   + t[..., None, :])
        e1 = ((_project(X2_in_1, K_intr) - uv1) ** 2).sum(-1)
        e2 = ((_project(X1_in_2, K_intr) - uv2) ** 2).sum(-1)
        inl = valid & (e1 < chi2_th) & (e2 < chi2_th)
        return inl, inl.sum(-1, dtype=torch.int32)

    with full_f32():
        Rs, ts, ss = sim3_horn(X1[sets], X2[sets])
        _, ns = score(Rs, ts, ss)
        best = torch.argmax(ns)  # the first maximum, as jnp.argmax
        R, t, s = Rs[best], ts[best], ss[best]
        inl, n = score(R, t, s)
    return Sim3RansacResult(n >= min_inliers, R, t, s, inl, n)


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


def optimize_sim3(R0, t0, s0, X1, X2, uv1, uv2, w1, w2, valid, K_intr, *,
                  iters: int = 10, huber: float = 3.1622776601683795):
    """Optimizer::OptimizeSim3 (optimizer.cpp:1062-1254): refine S21 over
    paired projection residuals, prune chi2 > 10 after 5 iterations,
    continue on inliers; returns (R, t, s, inlier mask, inlier count)."""

    def compose(xi):
        dR, dt, ds = sim3_exp(xi)
        return (dR @ R0, ds[..., None] * (dR @ t0[:, None])[..., 0] + dt,
                ds * s0)

    def residuals(xi):
        R, t, s = compose(xi)
        X1_in_2 = (s[..., None, None] * (X1 @ R.transpose(-1, -2))
                   + t[..., None, :])
        X2_in_1 = (1.0 / s)[..., None, None] * ((X2 - t[..., None, :]) @ R)
        r2 = _project(X1_in_2, K_intr) - uv2
        r1 = _project(X2_in_1, K_intr) - uv1
        return r1, r2, (r1 * r1 * w1).sum(-1), (r2 * r2 * w2).sum(-1)

    def stacked(x):
        # a batch of one: torch.func's jvp gives a float64 tangent to a
        # 0-dim tensor combined with a Python number
        r1, r2, _, _ = residuals(x[None])
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    def cost_of(xi, active):
        _, _, chi1, chi2_ = residuals(xi)
        return (lm.huber_rho(chi1, huber) * active
                + lm.huber_rho(chi2_, huber) * active).sum()

    def system(xi, active):
        r = stacked(xi)
        J = jacfwd(stacked)(xi)
        _, _, chi1, chi2_ = residuals(xi)
        wrob1 = lm.huber_weight(chi1, huber) * active
        wrob2 = lm.huber_weight(chi2_, huber) * active
        wvec = torch.cat([(w1 * wrob1[:, None]).reshape(-1),
                          (w2 * wrob2[:, None]).reshape(-1)])
        H = J.T @ (J * wvec[:, None])
        b = -J.T @ (r * wvec)
        return H, b

    def run(xi, active, n):
        H0, _ = system(xi, active)
        lam = lm.lm_init_lambda(H0)
        nu = torch.tensor(2.0, device=xi.device)
        cost = cost_of(xi, active)
        for _ in range(n):
            H, b = system(xi, active)
            dx = lm.solve_damped(H, b, lam)
            xi_new = sim3_log(*sim3_mul(sim3_exp(dx), sim3_exp(xi)))
            cost_new = cost_of(xi_new, active)
            accept = (cost_new < cost) & torch.isfinite(cost_new)
            rho = lm.gain_ratio(cost, cost_new, dx, b, lam)
            lam, nu = lm.lm_update(accept, rho, lam, nu)
            xi = torch.where(accept, xi_new, xi)
            cost = torch.where(accept, cost_new, cost)
        return xi

    with full_f32():
        active0 = valid.float()
        xi = torch.zeros(7, dtype=X1.dtype, device=X1.device)
        xi = run(xi, active0, 5)
        _, _, chi1, chi2_ = residuals(xi)
        keep = valid & (chi1 <= 10.0) & (chi2_ <= 10.0)
        xi = run(xi, keep.float(), iters)
        _, _, chi1, chi2_ = residuals(xi)
        inlier = keep & (chi1 <= 10.0) & (chi2_ <= 10.0)
        R, t, s = compose(xi)
    return R, t, s, inlier, inlier.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Essential-graph (Sim3 pose graph) optimization
# ---------------------------------------------------------------------------


def _edge_residual(xi_i, xi_j, meas):
    """log(Sji_meas * Siw * Swj) of one edge."""
    err = sim3_mul(sim3_mul(sim3_exp(meas), sim3_exp(xi_i)),
                   sim3_inverse(sim3_exp(xi_j)))
    return sim3_log(*err)


def _edge_linearized(dxi, dxj, xi_i, xi_j, meas):
    """The residual of the *perturbed* nodes composed directly in the
    group, with exactly one log at the end (intermediate log/exp round
    trips make float32 jacfwd knife-edge unstable)."""
    Si = sim3_mul(sim3_exp(dxi), sim3_exp(xi_i))
    Sj = sim3_mul(sim3_exp(dxj), sim3_exp(xi_j))
    err = sim3_mul(sim3_mul(sim3_exp(meas), Si), sim3_inverse(Sj))
    return sim3_log(*err)


def _edge_system(xi_i, xi_j, meas):
    """One edge's residual and its Jacobians in the two perturbations.
    The nodes are lifted to a batch of one: torch.func's jvp gives a
    float64 tangent to a 0-dim tensor combined with a Python number."""
    def r_of(dxi, dxj):
        return _edge_linearized(dxi, dxj, xi_i[None], xi_j[None],
                                meas[None])[0]

    z = torch.zeros_like(xi_i)[None]
    r = r_of(z, z)
    Ji = jacfwd(r_of, argnums=0)(z, z)[:, 0]
    Jj = jacfwd(r_of, argnums=1)(z, z)[:, 0]
    return r, Ji, Jj


def optimize_pose_graph(xi_nodes, fixed, edge_i, edge_j, edge_meas,
                        edge_valid, *, iters: int = 20):
    """Sim3 pose graph: nodes xi (N, 7) = log Siw; edges measure
    Sji = Sjw * Swi; residual = log(Sji_meas * Siw * Swj) with unit
    information (optimizer.cpp:776-1060).  edge_meas (E, 7) = log of the
    measured Sji.  Dense 7N normal equations; fixed nodes take no step."""
    N = xi_nodes.shape[0]
    dev = xi_nodes.device
    ei = edge_i.long()
    ej = edge_j.long()
    m = edge_valid.to(xi_nodes.dtype)
    free = (~fixed).to(xi_nodes.dtype)
    eye = torch.eye(N * 7, dtype=xi_nodes.dtype, device=dev)

    def cost_of(x):
        r = _edge_residual(x[ei], x[ej], edge_meas)
        r = torch.where(edge_valid[:, None], r, 0.0)
        return (r * r).sum()

    def system(x):
        r, Ji, Jj = vmap(_edge_system)(x[ei], x[ej], edge_meas)
        r = r * m[:, None]
        Ji = Ji * m[:, None, None]
        Jj = Jj * m[:, None, None]
        # (N, N, 7, 7) blocks; edges repeat node indices, so accumulate
        H = torch.zeros(N, N, 7, 7, dtype=x.dtype, device=dev)
        H.index_put_((ei, ei), torch.einsum("eri,erj->eij", Ji, Ji),
                     accumulate=True)
        H.index_put_((ej, ej), torch.einsum("eri,erj->eij", Jj, Jj),
                     accumulate=True)
        H.index_put_((ei, ej), torch.einsum("eri,erj->eij", Ji, Jj),
                     accumulate=True)
        H.index_put_((ej, ei), torch.einsum("eri,erj->eij", Jj, Ji),
                     accumulate=True)
        b = torch.zeros(N, 7, dtype=x.dtype, device=dev)
        b.index_put_((ei,), -torch.einsum("eri,er->ei", Ji, r),
                     accumulate=True)
        b.index_put_((ej,), -torch.einsum("eri,er->ei", Jj, r),
                     accumulate=True)
        return H.permute(0, 2, 1, 3).reshape(N * 7, N * 7), b

    def apply(x, dx):
        d = dx.reshape(N, 7) * free[:, None]
        return sim3_log(*sim3_mul(sim3_exp(d), sim3_exp(x)))

    with full_f32():
        x = xi_nodes
        # g2o seeds lambda at 1e-16 (fine in double); in float32 a rejected
        # near-GN step only doubles lambda per trip and the solve can stall
        # for the whole budget: seed relative to the Hessian scale instead
        H0, _ = system(x)
        lam = torch.clamp_min(1e-6 * torch.diagonal(H0).abs().max(), 1e-12)
        nu = torch.tensor(10.0, dtype=x.dtype, device=dev)
        cost = cost_of(x)
        fmask = free.repeat_interleave(7)
        for _ in range(iters):
            H, b = system(x)
            Hm = H * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
            bm = b.reshape(-1) * fmask
            dx, _ = torch.linalg.solve_ex(Hm + lam * eye, bm[:, None])
            dx = dx[:, 0]
            x_new = apply(x, dx)
            cost_new = cost_of(x_new)
            accept = (cost_new < cost) & torch.isfinite(cost_new)
            rho = lm.gain_ratio(cost, cost_new, dx, bm, lam)
            lam, nu = lm.lm_update(accept, rho, lam, nu)
            x = torch.where(accept, x_new, x)
            cost = torch.where(accept, cost_new, cost)
    return x
