"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

The port of the JAX package's geometry/twoview.py (Initializer): all
hypotheses of both models as one batch (8-point solves by batched SVD,
vectorized scoring), the all-inlier refit of each winner, model selection
RH = SH / (SH + SF) > 0.40, then ReconstructH (8 Faugeras motions) and
ReconstructF (4 motions of E) through CheckRT.  Both reconstructions run
and the selected one is kept by `torch.where`, so nothing reads back.

The RANSAC draws are an argument: (iters, 8) integer positions into the
valid matches, taken modulo the valid count, so the JAX package's
`jax.random.randint` draws (already in range) pass through unchanged and
any generator's raw integers work too.

Singular vectors are defined up to sign; every quantity taken from one
here (a model, a point, a motion) is either sign-free or enumerated with
both signs, so the selected reconstruction does not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sp_orb_slam_tpu_torch.geometry.triangulation import svd, triangulate

TH_H = 5.991
TH_F = 3.841
TH_F_SCORE = 5.991


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Mean-absolute-deviation normalization (initializer.cpp:698-742)."""
    n = valid.sum().clamp_min(1)
    m = valid[:, None]
    mean = torch.where(m, uv, 0.0).sum(0) / n
    dev = torch.where(m, (uv - mean).abs(), 0.0).sum(0) / n
    s = 1.0 / dev.clamp_min(1e-9)
    T = torch.zeros((3, 3), dtype=uv.dtype, device=uv.device)
    T[0, 0], T[1, 1], T[2, 2] = s[0], s[1], 1.0
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (uv - mean) * s, T


def _h_dlt(p1: torch.Tensor, p2: torch.Tensor, mask=None) -> torch.Tensor:
    """H21 DLT from normalized correspondences (..., N, 2); an optional row
    mask zeroes non-inlier rows (the all-inlier refit)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    if mask is not None:
        m = mask.to(p1.dtype)[..., None]
        r1, r2 = r1 * m, r2 * m
    A = torch.cat([r1, r2], -2)
    vh = svd(A, full_matrices=False)[2]
    return vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3))


def _f_8point(p1: torch.Tensor, p2: torch.Tensor, mask=None) -> torch.Tensor:
    """F21 from normalized correspondences + rank-2 projection."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], -1)
    if mask is not None:
        A = A * mask.to(p1.dtype)[..., None]
        vh = svd(A, full_matrices=False)[2]
    else:
        # minimal case: A is (8, 9) and the null vector lives only in the
        # FULL right singular basis
        vh = svd(A)[2]
    Fpre = vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3))
    u, w, vt = svd(Fpre)
    w = torch.cat([w[..., :2], torch.zeros_like(w[..., 2:])], -1)
    return (u * w[..., None, :]) @ vt


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _score_h(H21, uv1, uv2, valid):
    """CheckHomography: symmetric transfer, per hypothesis (..., 3, 3)."""
    H12, _ = torch.linalg.inv_ex(H21)

    def transfer(H, src, dst):
        p = _hom(src) @ H.transpose(-1, -2)
        w = torch.where(p[..., 2].abs() < 1e-12, 1e-12, p[..., 2])
        return ((dst - p[..., :2] / w[..., None]) ** 2).sum(-1)

    chi1 = transfer(H12, uv2, uv1)
    chi2 = transfer(H21, uv1, uv2)
    in1, in2 = chi1 <= TH_H, chi2 <= TH_H
    score = (torch.where(valid & in1, TH_H - chi1, 0.0)
             + torch.where(valid & in2, TH_H - chi2, 0.0)).sum(-1)
    return score, valid & in1 & in2


def _score_f(F21, uv1, uv2, valid):
    """CheckFundamental: epipolar distances both ways."""
    p1, p2 = _hom(uv1), _hom(uv2)

    def epi_dist(l, pts):
        num = (l[..., :2] * pts).sum(-1) + l[..., 2]
        den = (l[..., 0] ** 2 + l[..., 1] ** 2).clamp_min(1e-12)
        return num * num / den

    chi1 = epi_dist(p1 @ F21.transpose(-1, -2), uv2)  # lines in image 2
    chi2 = epi_dist(p2 @ F21, uv1)                    # lines in image 1
    in1, in2 = chi1 <= TH_F, chi2 <= TH_F
    score = (torch.where(valid & in1, TH_F_SCORE - chi1, 0.0)
             + torch.where(valid & in2, TH_F_SCORE - chi2, 0.0)).sum(-1)
    return score, valid & in1 & in2


def _check_rt(R, t, uv1, uv2, inliers, K, th2):
    """CheckRT, batched over motions R (M, 3, 3), t (M, 3) and matches."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    M = R.shape[0]
    # triangulate in normalized camera coordinates (float32 conditioning)
    xn1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    P1 = torch.eye(3, 4, dtype=R.dtype, device=R.device).expand(M, 3, 4)
    P2 = torch.cat([R, t[..., None]], -1)
    X = triangulate(P1, P2, xn1.expand(M, -1, -1), xn2.expand(M, -1, -1))

    finite = torch.isfinite(X).all(-1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    n2 = X - O2[:, None, :]
    d1 = torch.linalg.vector_norm(X, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = (X * n2).sum(-1) / (d1 * d2).clamp_min(1e-12)

    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    low_par = cos_par >= 0.99998
    cheir = ((X[..., 2] > 0) | low_par) & ((Xc2[..., 2] > 0) | low_par)

    def reproj_err(pc, uv):
        zsafe = torch.where(pc[..., 2].abs() < 1e-12, 1e-12, pc[..., 2])
        u = fx * pc[..., 0] / zsafe + cx
        v = fy * pc[..., 1] / zsafe + cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    e_ok = (reproj_err(X, uv1) <= th2) & (reproj_err(Xc2, uv2) <= th2)
    counted = inliers & finite & cheir & e_ok  # contributes to nGood
    good = counted & (cos_par < 0.99998)       # vbGood (triangulated)
    n_good = counted.sum(-1)

    # parallax = acos of the 50th smallest cosine among counted
    cos_sorted = torch.sort(torch.where(counted, cos_par, 2.0), -1).values
    idx = (n_good - 1).clamp(0, 50)
    par_cos = cos_sorted.gather(-1, idx[:, None])[:, 0].clamp(-1.0, 1.0)
    parallax = torch.where(n_good > 0, torch.rad2deg(torch.arccos(par_cos)),
                           0.0)
    return n_good, parallax, X, good


def _decompose_e(E):
    u, _, vt = svd(E)
    t = u[:, 2] / torch.linalg.vector_norm(u[:, 2])
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = u @ W.T @ vt
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _kmat(K):
    Km = torch.zeros((3, 3), dtype=K.dtype, device=K.device)
    Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2], Km[2, 2] = K[0], K[1], K[2], K[3], 1
    return Km


def _faugeras_motions(H21, K):
    """The 8 Faugeras hypotheses of ReconstructH (initializer.cpp:541-641).
    Returns (ok, R (8, 3, 3), t (8, 3))."""
    Km = _kmat(K)
    Kinv, _ = torch.linalg.inv_ex(Km)
    U, w, Vt = svd(Kinv @ H21 @ Km)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    ok = (d1 / d2 >= 1.00001) & (d2 / d3 >= 1.00001)
    eps = 1e-12
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + eps))
                      .clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + eps))
                      .clamp_min(0.0))
    sgn1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=w.dtype,
                        device=w.device)
    sgn3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=w.dtype,
                        device=w.device)
    x1s, x3s = aux1 * sgn1, aux3 * sgn3
    ssin = sgn1 * sgn3           # [+, -, -, +]
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                      .clamp_min(0.0))
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    # d' > 0 branch
    st = root / ((d1 + d3) * d2) * ssin
    ct = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand(4)
    Rp = torch.stack([torch.stack([ct, zero, -st], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([st, zero, ct], -1)], -2)
    tp = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)
    # d' < 0 branch
    sp = root / ((d1 - d3) * d2 + eps) * ssin
    cp = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + eps)).expand(4)
    Rn = torch.stack([torch.stack([cp, zero, sp], -1),
                      torch.stack([zero, -one, zero], -1),
                      torch.stack([sp, zero, -cp], -1)], -2)
    tn = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)

    R = s * U @ torch.cat([Rp, Rn]) @ Vt
    t = (U @ torch.cat([tp, tn])[..., None])[..., 0]
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(eps)
    return ok, R, t


class InitResult(NamedTuple):
    ok: torch.Tensor            # () bool
    used_h: torch.Tensor        # () bool (model selection outcome)
    R21: torch.Tensor           # (3, 3)
    t21: torch.Tensor           # (3,)
    points: torch.Tensor        # (N, 3) triangulated in camera-1 frame
    triangulated: torch.Tensor  # (N,) bool per match


def initialize(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, draws: torch.Tensor, *, sigma: float = 1.0,
               min_parallax: float = 1.0,
               min_triangulated: int = 50) -> InitResult:
    """Two-view bootstrap on matched pairs uv1/uv2 (N, 2) + valid mask, with
    the RANSAC hypotheses' sample positions `draws` (iters, 8)."""
    n_valid = valid.sum()
    nuv1, T1 = _normalize(uv1, valid)
    nuv2, T2 = _normalize(uv2, valid)
    T2inv, _ = torch.linalg.inv_ex(T2)

    # sample positions in the valid set (valid entries first, stable)
    valid_idx = torch.argsort((~valid).to(torch.uint8), stable=True)
    draws = draws.to(device=uv1.device, dtype=torch.long)
    sets = valid_idx[draws % n_valid.clamp_min(1)]       # (iters, 8)

    Hs = T2inv @ _h_dlt(nuv1[sets], nuv2[sets]) @ T1
    Fs = T2.T @ _f_8point(nuv1[sets], nuv2[sets]) @ T1
    h_scores, _ = _score_h(Hs, uv1, uv2, valid)
    f_scores, _ = _score_f(Fs, uv1, uv2, valid)
    H21 = Hs[torch.argmax(h_scores)]
    F21 = Fs[torch.argmax(f_scores)]
    SH0, h_in0 = _score_h(H21, uv1, uv2, valid)
    SF0, f_in0 = _score_f(F21, uv1, uv2, valid)

    # re-estimate each model from all inliers of its best hypothesis; keep
    # the RANSAC winner when the refit is degenerate (score craters)
    H21r = T2inv @ _h_dlt(nuv1, nuv2, h_in0) @ T1
    F21r = T2.T @ _f_8point(nuv1, nuv2, f_in0) @ T1
    SHr, h_inr = _score_h(H21r, uv1, uv2, valid)
    SFr, f_inr = _score_f(F21r, uv1, uv2, valid)
    use_hr = SHr >= 0.5 * SH0
    use_fr = SFr >= 0.5 * SF0
    H21 = torch.where(use_hr, H21r, H21)
    SH = torch.where(use_hr, SHr, SH0)
    h_inliers = torch.where(use_hr, h_inr, h_in0)
    F21 = torch.where(use_fr, F21r, F21)
    SF = torch.where(use_fr, SFr, SF0)
    f_inliers = torch.where(use_fr, f_inr, f_in0)

    use_h = SH / (SH + SF).clamp_min(1e-9) > 0.40
    th2 = 4.0 * sigma * sigma

    # ReconstructH
    ok_dec, Rs, ts = _faugeras_motions(H21, K)
    n_in = h_inliers.sum()
    ng, par, X, good = _check_rt(Rs, ts, uv1, uv2, h_inliers, K, th2)
    order = torch.argsort(-ng, stable=True)
    best, second = order[0], order[1]
    ok_h = (ok_dec & (ng[second] < 0.75 * ng[best])
            & (par[best] >= min_parallax) & (ng[best] > min_triangulated)
            & (ng[best] > 0.9 * n_in))
    res_h = (ok_h, Rs[best], ts[best], X[best], good[best])

    # ReconstructF
    E = _kmat(K).T @ F21 @ _kmat(K)
    R1, R2, t = _decompose_e(E)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    n_in = f_inliers.sum()
    ng, par, X, good = _check_rt(Rs, ts, uv1, uv2, f_inliers, K, th2)
    max_good = ng.max()
    best = torch.argmax(ng)
    n_min = (0.9 * n_in).long().clamp_min(min_triangulated)
    n_similar = (ng > 0.7 * max_good).sum()
    ok_f = (max_good >= n_min) & (n_similar == 1) & (par[best] > min_parallax)
    res_f = (ok_f, Rs[best], ts[best], X[best], good[best])

    ok, R21, t21, X, good = (torch.where(use_h, a, b)
                             for a, b in zip(res_h, res_f))
    return InitResult(ok & (n_valid >= 8), use_h, R21, t21, X, good)
