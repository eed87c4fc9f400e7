"""Descriptor matching as masked distance ops.

The port of the JAX package's ops/matching.py (the SPMatcher family,
src/cv/sp_matcher.cpp): the full pairwise L2 matrix of unit descriptors
(||a-b|| = sqrt(2 - 2 a.b), a full-float32 matmul), and every Search*
variant as a different mask over it: best + second with the first minimal
index, then uniqueness by minimum distance, then the smaller row (the
reference's first-come order becomes order-independent).  The init matcher
takes any leading batch dimensions; the tracking and mapping matchers work
on one frame.

Constants (sp_matcher.cpp:18-19): TH_HIGH = 0.7, TH_LOW = 0.3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sp_orb_slam_tpu_torch.utils.precision import full_f32

TH_HIGH = 0.7
TH_LOW = 0.3
BIG = 1e9


def pairwise_dist(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """L2 distances between unit descriptors: (..., M, D) x (..., N, D) ->
    (..., M, N), with full-float32 dot products (no TF32)."""
    with full_f32():
        dots = torch.matmul(desc_a, desc_b.transpose(-1, -2))
    return torch.sqrt((2.0 - 2.0 * dots).clamp_min(0.0))


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best, first minimal index and second best over masked
    entries (masked-out entries count as BIG); `second` excludes only the
    best index, so an equal-distance duplicate surfaces as `second`."""
    d = torch.where(mask, dist, BIG)
    best = d.amin(-1)
    idx = d.argmin(-1).to(torch.int32)  # the first minimal index
    cols = torch.arange(d.shape[-1], device=d.device, dtype=torch.int32)
    second = torch.where(cols == idx[..., None], BIG, d).amin(-1)
    return best, idx, second


def resolve_mutual(best_idx: torch.Tensor, best_dist: torch.Tensor,
                   row_ok: torch.Tensor, num_cols: int):
    """Each column keeps its minimum-distance claimant, ties to the smaller
    row.  Returns (match12 (..., M) int32 column or -1, match21 (..., N)
    int32 row or -1)."""
    M = best_idx.shape[-1]
    dev = best_idx.device
    rows = torch.arange(M, dtype=torch.int32, device=dev)
    cols = torch.arange(num_cols, dtype=torch.int32, device=dev)
    claim = row_ok[..., None] & (best_idx[..., None] == cols)
    dmat = torch.where(claim, best_dist[..., None], BIG)
    min_d = dmat.amin(-2)                                 # per column
    cand = claim & (dmat == min_d[..., None, :])
    min_r = torch.where(cand, rows[:, None], M).amin(-2).to(torch.int32)
    safe_col = best_idx.clamp(0, num_cols - 1).long()
    winner = row_ok & (torch.gather(min_r, -1, safe_col) == rows)
    match12 = torch.where(winner, best_idx, -1)
    match21 = torch.where(min_r < M, min_r, -1)
    return match12, match21


def window_mask(uv_a: torch.Tensor, valid_a: torch.Tensor,
                uv_b: torch.Tensor, valid_b: torch.Tensor,
                radius) -> torch.Tensor:
    """(..., M, N) mask: b within the square window of radius r around a
    (GetFeaturesInArea semantics: strict |du| < r and |dv| < r)."""
    du = (uv_a[..., :, None, 0] - uv_b[..., None, :, 0]).abs()
    dv = (uv_a[..., :, None, 1] - uv_b[..., None, :, 1]).abs()
    return ((du < radius) & (dv < radius) & valid_a[..., :, None]
            & valid_b[..., None, :])


class InitMatches(NamedTuple):
    match12: torch.Tensor    # (..., M) index into frame-2 keypoints, -1 if none
    n_matches: torch.Tensor  # (...) int32


def init_match(desc1, valid1, prev_uv, desc2, uv2, valid2, *,
               window: float = 100, ratio: float = 0.9, th: float = TH_LOW):
    """The whole init matcher: (match12, n, match21) as the kernel in
    ops/cuda_match.py returns them."""
    dist = pairwise_dist(desc1, desc2)
    mask = window_mask(prev_uv, valid1, uv2, valid2, window)
    best, idx, second = masked_best2(dist, mask)
    row_ok = valid1 & (best <= th) & (best < ratio * second)
    match12, match21 = resolve_mutual(idx, best, row_ok, desc2.shape[-2])
    return match12, (match12 >= 0).sum(-1, dtype=torch.int32), match21


def search_for_initialization(desc1, valid1, prev_uv, desc2, uv2, valid2,
                              *, window: int = 100,
                              ratio: float = 0.9) -> InitMatches:
    """SearchForInitialization (sp_matcher.cpp:666-734): windowed best +
    second with ratio test at TH_LOW, mutual uniqueness."""
    match12, n, _ = init_match(desc1, valid1, prev_uv, desc2, uv2, valid2,
                               window=window, ratio=ratio)
    return InitMatches(match12, n)


def search_by_projection_points(mp_desc, mp_proj_uv, mp_view_cos, mp_valid,
                                kp_desc, kp_uv, kp_valid, kp_free, *,
                                th: float, match_adaptive: bool,
                                c2_thresh: float, th_dist: float = TH_HIGH):
    """SearchByProjection frame vs. local-map points (sp_matcher.cpp:
    344-432): window radius RadiusByViewingCos (2.5 if viewCos > 0.998 else
    4.0) times `th` over the free keypoints; accept best <= th_dist, else
    the adaptive gate 1.2 c2 / (c2 + duv).  Returns (match (P,) keypoint or
    -1, match21 (K,) point or -1)."""
    radius = torch.where(mp_view_cos > 0.998, 2.5, 4.0) * th
    du = kp_uv[None, :, 0] - mp_proj_uv[:, None, 0]
    dv = kp_uv[None, :, 1] - mp_proj_uv[:, None, 1]
    mask = ((du.abs() < radius[:, None]) & (dv.abs() < radius[:, None])
            & mp_valid[:, None] & (kp_valid & kp_free)[None, :])
    best, idx, _ = masked_best2(pairwise_dist(mp_desc, kp_desc), mask)
    col = idx.long()[:, None]
    duv = du.gather(1, col)[:, 0] ** 2 + dv.gather(1, col)[:, 0] ** 2
    if match_adaptive:
        fallback = best < (1.2 * c2_thresh / (c2_thresh + duv))
    else:
        fallback = best < 0.7
    row_ok = mp_valid & (best < BIG) & ((best <= th_dist) | fallback)
    return resolve_mutual(idx, best, row_ok, kp_desc.shape[0])


def search_by_projection_frame(mp_desc, mp_proj_uv, mp_depth_ok, mp_valid,
                               kp_desc, kp_uv, kp_valid, kp_free, *,
                               radius: float, bounds):
    """SearchByProjection current vs. last frame (sp_matcher.cpp:
    1439-1543): fixed-radius window around each projected point, accept
    best <= TH_HIGH."""
    in_img = ((mp_proj_uv[:, 0] >= bounds[0])
              & (mp_proj_uv[:, 0] <= bounds[1])
              & (mp_proj_uv[:, 1] >= bounds[2])
              & (mp_proj_uv[:, 1] <= bounds[3]))
    ok = mp_valid & mp_depth_ok & in_img
    mask = window_mask(mp_proj_uv, ok, kp_uv, kp_valid & kp_free, radius)
    best, idx, _ = masked_best2(pairwise_dist(mp_desc, kp_desc), mask)
    return resolve_mutual(idx, best, ok & (best <= TH_HIGH),
                          kp_desc.shape[0])


def search_by_brute_force(mp_desc, mp_valid, kp_desc, kp_valid):
    """SearchByBruteForce KF -> frame (sp_matcher.cpp:1642-1674): mutual
    nearest neighbours, no distance threshold.  Returns (K,) int32 index
    into the point rows for each keypoint, -1 if not mutual-best."""
    dist = pairwise_dist(mp_desc, kp_desc)  # (P, K)
    d = torch.where(mp_valid[:, None] & kp_valid[None, :], dist, BIG)
    best_k_for_p = d.argmin(1)
    best_p_for_k = d.argmin(0)
    K = kp_desc.shape[0]
    mutual = (best_k_for_p[best_p_for_k]
              == torch.arange(K, device=d.device)) & kp_valid
    finite = d.gather(0, best_p_for_k[None, :])[0] < BIG
    return torch.where(mutual & finite, best_p_for_k, -1).to(torch.int32)


def search_for_triangulation(desc1, valid1, free1, desc2, uv2, valid2, free2,
                             epipole2_uv, F12, uv1, cov2_inv2, *,
                             ratio: float = 0.7):
    """SearchForTriByFlann (sp_matcher.cpp:183-262), exact: the free
    features of KF2 against those of KF1 with the 2-NN ratio test, the
    epipole-proximity rejection (dist^2 < 100) and the covariance-scaled
    epipolar-line gate d^2 < 3.84 / min(cov2_inv).  Returns match21 (N2,)
    index into KF1 features or -1."""
    dist = pairwise_dist(desc2, desc1)  # rows = KF2 queries
    mask = (valid2 & free2)[:, None] & (valid1 & free1)[None, :]
    best, idx1, second = masked_best2(dist, mask)
    row_ok = (valid2 & free2) & (best < BIG) & (best < ratio * second)
    de = uv2 - epipole2_uv[None, :]
    row_ok &= (de * de).sum(-1) >= 100.0
    # epipolar line of the matched KF1 feature in image 2
    lines = torch.cat([uv1, torch.ones_like(uv1[:, :1])], -1) @ F12
    line = lines[idx1.long()]
    num = line[:, 0] * uv2[:, 0] + line[:, 1] * uv2[:, 1] + line[:, 2]
    den = line[:, 0] ** 2 + line[:, 1] ** 2
    dsqr = num * num / den.clamp_min(1e-12)
    factor = 1.0 / cov2_inv2.amin(-1).clamp_min(1e-12)
    row_ok &= (den > 0) & (dsqr < 3.84 * factor)
    match21, _ = resolve_mutual(idx1, best, row_ok, desc1.shape[0])
    return match21


def search_for_tri_by_epi(desc1, uv1, free1, desc2, uv2, free2,
                          epipole2_uv, F12, R21, K_intr, cov2_inv2, *,
                          th_dist: float = TH_HIGH, band: float = 8.0):
    """SearchForTriByEpi (sp_matcher.cpp:24-181), the `matching_method: 2`
    triangulation matcher, in the JAX package's band-mask form: the walk
    along the epipolar segment from the epipole e2 to 2 p_inf - e2 (p_inf:
    the infinite-depth projection of a free KF1 feature, which must lie in
    front of camera 2) becomes a band around that segment, t in [-slack,
    1 + slack] and lateral^2 <= band^2 with slack = band / |segment|; a
    candidate keypoint of KF2 must also pass the epipole-proximity gate
    (d^2 >= 100) and the covariance-scaled epipolar-line gate (d^2 < 3.84 /
    min cov2_inv).  The best L2 candidate below `th_dist` wins, each KF2
    keypoint kept by its minimum-distance claimant.  Returns match21 (N2,)
    index into KF1 features or -1."""
    fx, fy, cx, cy = K_intr[0], K_intr[1], K_intr[2], K_intr[3]
    # infinite-depth projection of each KF1 feature in image 2 (:56-63)
    x1n = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy,
                       torch.ones_like(uv1[:, 0])], -1)       # (N1, 3)
    with full_f32():
        ray2 = x1n @ R21.T
    z = torch.where(ray2[:, 2].abs() < 1e-9, 1e-9, ray2[:, 2])
    p_inf = torch.stack([fx * ray2[:, 0] / z + cx,
                         fy * ray2[:, 1] / z + cy], -1)        # (N1, 2)
    seg_end = 2.0 * p_inf - epipole2_uv[None, :]  # uv += uv - e (:62-63)

    # segment-band membership of every KF2 keypoint (the cell walk)
    s = seg_end - epipole2_uv[None, :]                         # (N1, 2)
    w = uv2[None, :, :] - epipole2_uv[None, None, :]           # (1, N2, 2)
    ss = (s * s).sum(-1).clamp_min(1e-12)                      # (N1,)
    t = (w[..., 0] * s[:, None, 0] + w[..., 1] * s[:, None, 1]) / ss[:, None]
    lat2 = (w * w).sum(-1) - t * t * ss[:, None]               # (N1, N2)
    slack = band / torch.sqrt(ss)
    in_seg = ((t >= -slack[:, None]) & (t <= 1.0 + slack[:, None])
              & (lat2 <= band * band) & (ray2[:, 2] > 0)[:, None])

    # epipole proximity of the candidate (:125-131; scale factor 1)
    de = uv2 - epipole2_uv[None, :]
    far_from_epipole = (de * de).sum(-1) >= 100.0

    # covariance-scaled epipolar-line gate (CheckDistEpipolarLine)
    with full_f32():
        lines = torch.cat([uv1, torch.ones_like(uv1[:, :1])], -1) @ F12
    num = (lines[:, None, 0] * uv2[None, :, 0]
           + lines[:, None, 1] * uv2[None, :, 1] + lines[:, None, 2])
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    dsqr = num * num / den[:, None].clamp_min(1e-12)
    factor = 1.0 / cov2_inv2.amin(-1).clamp_min(1e-12)
    epi_ok = (den[:, None] > 0) & (dsqr < 3.84 * factor[None, :])

    mask = (free1[:, None] & (free2 & far_from_epipole)[None, :]
            & in_seg & epi_ok)
    best, idx2, _ = masked_best2(pairwise_dist(desc1, desc2), mask)
    row_ok = free1 & (best < th_dist)
    _, match21 = resolve_mutual(idx2, best, row_ok, desc2.shape[0])
    return match21


def fuse_candidates(mp_desc, mp_proj_uv, mp_valid, kp_desc, kp_uv, kp_valid,
                    *, radius: float):
    """The device part of SPMatcher::Fuse (sp_matcher.cpp:965-1104): per
    map point the best keypoint within `radius` passing the pyramid-sigma
    chi^2 gate e2 <= 5.99 and TH_LOW.  Returns (best_idx (P,) or -1,
    best_dist (P,))."""
    du = kp_uv[None, :, 0] - mp_proj_uv[:, None, 0]
    dv = kp_uv[None, :, 1] - mp_proj_uv[:, None, 1]
    mask = ((du.abs() < radius) & (dv.abs() < radius)
            & (du * du + dv * dv <= 5.99) & mp_valid[:, None]
            & kp_valid[None, :])
    best, idx, _ = masked_best2(pairwise_dist(mp_desc, kp_desc), mask)
    return torch.where(mp_valid & (best <= TH_LOW), idx, -1), best


def _sim3_side(pos_c, valid, desc, dmin, dmax, sR, t, kp_uv, kp_desc,
               kp_valid, K_intr, bounds, radius, th):
    """One direction of SearchBySim3: transform map points (camera frame)
    through the Sim3, project, gate, best-L2 window search."""
    with full_f32():
        pc = pos_c @ sR.T + t[None, :]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = torch.stack([K_intr[0] * pc[:, 0] / zs + K_intr[2],
                        K_intr[1] * pc[:, 1] / zs + K_intr[3]], -1)
    dist3 = torch.linalg.vector_norm(pc, dim=-1)
    ok = (valid & (z > 0)
          & (proj[:, 0] >= bounds[0]) & (proj[:, 0] <= bounds[1])
          & (proj[:, 1] >= bounds[2]) & (proj[:, 1] <= bounds[3])
          & (dist3 >= dmin) & (dist3 <= dmax))
    mask = window_mask(proj, ok, kp_uv, kp_valid, radius)
    best, idx, _ = masked_best2(pairwise_dist(desc, kp_desc), mask)
    return torch.where(ok & (best <= th), idx, -1)


def search_by_sim3(mp1_pos_c1, mp1_valid, mp1_desc, mp1_dmin, mp1_dmax,
                   kp1_uv, kp1_desc, kp1_valid,
                   mp2_pos_c2, mp2_valid, mp2_desc, mp2_dmin, mp2_dmax,
                   kp2_uv, kp2_desc, kp2_valid,
                   sR21, t21, sR12, t12, K_intr, bounds,
                   *, radius: float = 7.5):
    """SearchBySim3Override (sp_matcher_loop.cpp:7-220): mutual Sim3
    projection growth between two keyframes' map points.  Forward: KF1 map
    points (camera-1 frame) through sR21/t21 into image 2, best keypoint
    within `radius` at L2 <= 0.7; backward: KF2 map points through
    sR12/t12 into image 1.  The caller keeps the agreeing pairs
    (vnMatch2[vnMatch1[i1]] == i1, :211-223) and excludes already matched
    slots through the validity masks.  Returns (match1 (N1,) -> kp2 index
    or -1, match2 (N2,) -> kp1 index or -1)."""
    m1 = _sim3_side(mp1_pos_c1, mp1_valid, mp1_desc, mp1_dmin, mp1_dmax,
                    sR21, t21, kp2_uv, kp2_desc, kp2_valid, K_intr, bounds,
                    radius, TH_HIGH)
    m2 = _sim3_side(mp2_pos_c2, mp2_valid, mp2_desc, mp2_dmin, mp2_dmax,
                    sR12, t12, kp1_uv, kp1_desc, kp1_valid, K_intr, bounds,
                    radius, TH_HIGH)
    return m1, m2
