"""Per-frame tracking and mapping stages, one packed readback each.

The port of the JAX package's slam/kernels.py.  Each stage is a plain
PyTorch function of device tensors (the `*_body` functions) that the
host-facing `TrackingKernels` runs with ONE packed host-to-device upload of
its numpy arguments and ONE packed device-to-host copy of its results (a
flat float32 vector unpacked by `Layout`), so the host code reads results
exactly as it does in the JAX package:

- dust_track: PoseOptimizationDust -> 2x2 occ-grid patch association ->
  PoseOptimizationDustPost                (tracker_dust.cpp:22-228)
- heat_track: the same with PoseOptimizationHeat on the full-resolution
  heat map (coarse_method "heat")         (tracker_dust.cpp:405-446)
- motion_track: SearchByProjection vs the last frame at radius th, retried
  at 2 th when thin, + 4x10 PoseOptimization (tracker.cpp:480-559)
- ref_track / reloc_track: brute-force mutual NN vs a keyframe + pose
  optimization (multi-start for relocalization) (tracker.cpp:372-417)
- local_map_track: frustum + SearchByProjection vs the local map +
  PoseOptimization                        (tracker.cpp:561-832)
- fused_track: dust_track flowing into local_map_track on the device
- init_two_view: SearchForInitialization + the two-view bootstrap
                                          (mono_tracker.cpp:38-115)
- triangulate_pair_batch: per-neighbour match (matching_method 1, the
  exact 2-NN; 2, the epipolar walk) + DLT + gates
                                          (local_mapper.cpp:558-791)
- fuse: projection fuse candidates        (sp_matcher.cpp:965-1104)

The loops are Python loops with `torch.where` masks and the JAX package's
`lax.cond`s run both branches and select, so no stage reads a value back
before its single copy (the init stage reads the match count once: the
RANSAC draws depend on it).  Index arrays are int64 on the device and every
gather index is clamped into range (JAX clamps silently; CUDA asserts).
Conflicts resolve by minimum distance (ops/matching.py).  On the card the
init matcher is the `match` kernel (ops/cuda_match.py, batch 1).

The `*_batch` stages serve the fleet (slam/fleet.py) and the mapper: the
same bodies under `torch.func.vmap` (the counterpart of `jax.vmap`) over a
list of per-row argument tuples, with ONE packed upload of every row's host
arguments and ONE packed readback (`upload_rows`, `PreStacked`,
`BankRows`).  Every batched stage is vmapped; none loops over its rows.
With `TrackingKernels.batch_mesh` set (parallel/mesh.py; the fleet sets it
when it serves over a stream mesh), a batch whose row count the mesh's
slot count divides is split into one contiguous chunk per slot, each with
its own upload, vmap and readback on its slot's device (the counterpart of
the JAX package's `batch_sharding`); `last_batch_placement` records how
each batched stage last ran.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.geometry import twoview
from sp_orb_slam_tpu_torch.geometry.triangulation import (depth_and_tau,
                                                          triangulate,
                                                          triangulation_gates)
from sp_orb_slam_tpu_torch.ops import cuda_match, matching
from sp_orb_slam_tpu_torch.optim import pose as pose_opt
from sp_orb_slam_tpu_torch.utils.precision import full_f32
from sp_orb_slam_tpu_torch.utils.timing import span


# ---------------------------------------------------------------------------
# packed transfers
# ---------------------------------------------------------------------------


class Layout:
    """Named flat-float32 packing: one transfer per stage."""

    def __init__(self, specs: List[Tuple[str, tuple, type]]):
        self.specs = specs
        self.sizes = [int(np.prod(s)) if s else 1 for _, s, _ in specs]

    def pack(self, **tensors) -> torch.Tensor:
        """Device side: the named tensors as one flat float32 tensor."""
        return torch.cat([tensors[name].reshape(-1).to(torch.float32)
                          for name, _, _ in self.specs])

    def unpack(self, flat: np.ndarray) -> dict:
        """Host side: the flat vector back into named numpy fields (bools
        from > 0.5, ints by rounding; every index is < 2^24)."""
        out = {}
        off = 0
        for (name, shape, dtype), size in zip(self.specs, self.sizes):
            chunk = flat[off:off + size]
            chunk = chunk.reshape(shape) if shape else chunk[0]
            if dtype is bool:
                chunk = chunk > 0.5
            elif dtype is int:
                chunk = np.rint(chunk).astype(np.int64)
            out[name] = chunk
            off += size
        return out


def _as_kind(t: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """A slice of a packed float32 upload back in the kind of the numpy
    argument it came from: bools as bool, integers as int64 (exact below
    2^24), floats as they are."""
    if a.dtype == np.bool_:
        return t > 0.5
    if np.issubdtype(a.dtype, np.integer):
        return t.round().long()
    return t


def upload(args, device: torch.device) -> list:
    """Move a stage's arguments to `device`: every numpy (or Python scalar)
    argument travels in ONE packed float32 copy and is sliced back on the
    device (bools as bool, integers as int64, exact below 2^24); tensors
    pass through (moved if they live elsewhere)."""
    out = list(args)
    host = [(i, np.asarray(a)) for i, a in enumerate(args)
            if not isinstance(a, torch.Tensor)]
    if host:
        flat = np.concatenate([a.reshape(-1).astype(np.float32, copy=False)
                               for _, a in host])
        buf = torch.from_numpy(flat).to(device)
        off = 0
        for i, a in host:
            out[i] = _as_kind(buf[off:off + a.size].view(a.shape), a)
            off += a.size
    return [a.to(device) if a.device != device else a for a in out]


class PreStacked:
    """Marks a device argument that is ALREADY stacked across the rows of a
    batched stage: `upload_rows` uses `.array` (leading dim = rows) as it
    is instead of stacking per-row tensors, so the per-row slices never
    exist.  Every row of the batch carries the SAME object at that
    position (the fleet builds one per tick from the batched extraction
    output or the stacked descriptor banks)."""

    __slots__ = ("array",)

    def __init__(self, array: torch.Tensor):
        self.array = array


class BankRows:
    """Descriptor-argument placeholder for the fleet's bank mode: instead of
    a per-stream on-device row gather, the prep hands back the gather's
    inputs and the batched stage computes `where(valid, bank[rows], 0)`
    inside the batch (`_bank_variant`).  `version` is the pool's bank
    version at prep time: the port's banks are updated in place, so the
    fleet keys its stacked-bank cache on (bank, version)."""

    __slots__ = ("rows", "valid", "bank", "version")

    def __init__(self, rows, valid, bank, version: int = 0):
        self.rows = rows
        self.valid = valid
        self.bank = bank
        self.version = version


def _bank_variant(body_fn, desc_idx: int, valid_idx: int):
    """Wrap a stage so the descriptor argument at `desc_idx` is gathered
    inside it: callers pass the bank-row indices at `desc_idx` and append
    the descriptor bank as the LAST argument."""

    def fn(*args):
        rows, valid, bank = args[desc_idx], args[valid_idx], args[-1]
        inner = list(args[:-1])
        inner[desc_idx] = torch.where(valid[:, None], bank[rows], 0.0)
        return body_fn(*inner)

    return fn


def upload_rows(rows, device: torch.device) -> list:
    """The batched `upload`: a list of per-row argument tuples -> one
    stacked tensor per position.  Every host argument of every row travels
    in ONE packed (rows, L) float32 copy; per-row tensors are stacked on
    the device; a PreStacked is used as it is."""
    n = len(rows)
    out: list = [None] * len(rows[0])
    host = []
    for i in range(len(out)):
        col = [r[i] for r in rows]
        if isinstance(col[0], PreStacked):
            if any(c is not col[0] for c in col):
                raise ValueError("a PreStacked argument must be the same "
                                 "object in every row")
            out[i] = col[0].array.to(device)
        elif isinstance(col[0], torch.Tensor):
            out[i] = torch.stack([c.to(device) for c in col])
        else:
            host.append((i, np.stack([np.asarray(c) for c in col])))
    if host:
        flat = np.concatenate([a.reshape(n, -1).astype(np.float32, copy=False)
                               for _, a in host], axis=1)
        buf = torch.from_numpy(flat).to(device)
        off = 0
        for i, a in host:
            size = a[0].size
            out[i] = _as_kind(buf[:, off:off + size].reshape(a.shape), a)
            off += size
    return out


def _row_chunk(rows, lo: int, hi: int) -> list:
    """Rows lo..hi-1 of a batch, each PreStacked argument cut to the same
    rows (one new PreStacked per position, shared by the chunk's rows)."""
    if lo == 0 and hi == len(rows):
        return rows
    cut = {i: PreStacked(a.array[lo:hi]) for i, a in enumerate(rows[0])
           if isinstance(a, PreStacked)}
    return [tuple(cut.get(i, a) for i, a in enumerate(r))
            for r in rows[lo:hi]]


def _scatter_flags(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n,) bool: True at every idx >= 0 (idx values in [-1, n)).  Out of
    place, so the stages that use it run under torch.func.vmap."""
    slot = torch.where(idx >= 0, idx, n).long()
    flags = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    return flags.scatter(0, slot, True)[:n]


def _project(Tcw, pts, K_intr):
    """Camera-frame points, pixel projections (sign-preserving depth guard)
    and depths of world points under Tcw."""
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = torch.stack([K_intr[0] * pc[:, 0] / zs + K_intr[2],
                        K_intr[1] * pc[:, 1] / zs + K_intr[3]], -1)
    return pc, proj, z, zs


# ---------------------------------------------------------------------------
# stage bodies (pure functions of device tensors)
# ---------------------------------------------------------------------------


def _dust_association(proj_uv, in_view, mp_desc_track, occ_grid, kp_desc,
                      kp_valid):
    """Patch-wise association on the 1/8 occupancy grid (tracker_dust.cpp:
    105-172): 2x2 cell window around floor(proj), best descriptor distance
    < 0.75 against the tracking descriptor."""
    hc, wc = occ_grid.shape
    K = kp_desc.shape[0]
    u0 = proj_uv[:, 0].floor().clamp(-1.0, float(wc)).long().clamp(0, wc - 2)
    v0 = proj_uv[:, 1].floor().clamp(-1.0, float(hc)).long().clamp(0, hc - 2)
    best_dist = torch.full(u0.shape, 0.75, device=u0.device)
    best_idx = torch.full(u0.shape, -1, dtype=torch.long, device=u0.device)
    for du in (0, 1):
        for dv in (0, 1):
            idx = occ_grid[v0 + dv, u0 + du].long()
            idx_safe = idx.clamp(0, K - 1)
            cand_ok = (idx >= 0) & in_view & kp_valid[idx_safe]
            dot = (mp_desc_track * kp_desc[idx_safe]).sum(-1)
            d = torch.sqrt((2.0 - 2.0 * dot).clamp_min(0.0))
            better = cand_ok & (d < best_dist)
            best_dist = torch.where(better, d, best_dist)
            best_idx = torch.where(better, idx, best_idx)
    # each keypoint claimed once: min-distance wins
    return matching.resolve_mutual(best_idx.clamp_min(0), best_dist,
                                   best_idx >= 0, K)


def _coarse_track(res, cell_uv, mp_pos, mp_desc_track, occ_grid, kp_desc,
                  kp_uv, kp_cov2_inv, kp_valid, K_intr):
    """The coarse stage after its direct alignment `res`: the 2x2 occ-grid
    association at the projections `cell_uv` (1/8 cell coordinates), then
    PoseOptimizationDustPost over the associated pairs."""
    mp2kp, kp2mp = _dust_association(cell_uv, res.inlier, mp_desc_track,
                                     occ_grid, kp_desc, kp_valid)
    kp_has = kp2mp >= 0
    post = pose_opt.pose_optimization_post(
        res.Tcw, mp_pos[kp2mp.clamp_min(0).long()], kp_uv, kp_cov2_inv,
        kp_has, K_intr)
    return dict(
        Tcw=post.Tcw, Tcw_coarse=res.Tcw, kp2mp=kp2mp,
        post_inlier=post.inlier, n_coarse=res.n_inlier,
        n_match=(mp2kp >= 0).sum(), n_opt=post.n_inlier,
        mp_in_view=res.inlier, mp_matched=mp2kp >= 0)


def dust_track_body(Tcw_pred, mp_pos, mp_desc_track, mp_valid, dust,
                    occ_grid, kp_desc, kp_uv, kp_cov2_inv, kp_valid, K_intr,
                    *, dust_iters, huber_delta, chi2_inlier):
    res = pose_opt.pose_optimization_dust(
        Tcw_pred, mp_pos, mp_valid, dust, K_intr, iters=dust_iters,
        huber_delta=huber_delta, chi2_inlier=chi2_inlier)
    return _coarse_track(res, res.proj_uv, mp_pos, mp_desc_track, occ_grid,
                         kp_desc, kp_uv, kp_cov2_inv, kp_valid, K_intr)


def heat_track_body(Tcw_pred, mp_pos, mp_desc_track, mp_valid, heat,
                    occ_grid, kp_desc, kp_uv, kp_cov2_inv, kp_valid, K_intr,
                    *, heat_iters, huber_delta, chi2_inlier):
    """trackFrameHeat (tracker_dust.cpp:405-446): the full-resolution heat
    alignment (PoseOptimizationHeat) in place of the 1/8 dust alignment.
    The reference stops after the alignment; as the JAX package does, the
    dust stage's association and post optimization follow, so the variant
    is a complete coarse tracker."""
    res = pose_opt.pose_optimization_heat(
        Tcw_pred, mp_pos, mp_valid, heat, K_intr, iters=heat_iters,
        huber_delta=huber_delta, chi2_inlier=chi2_inlier)
    # full-resolution pixels -> 1/8 cell coordinates with the dust
    # intrinsics' offset (fx/8, (cx-3.5)/8; optimizer_dust.cpp:223-226)
    return _coarse_track(res, (res.proj_uv - 3.5) / 8.0, mp_pos,
                         mp_desc_track, occ_grid, kp_desc, kp_uv,
                         kp_cov2_inv, kp_valid, K_intr)


def motion_track_body(Tcw_pred, mp_pos, mp_desc_track, mp_valid, kp_desc,
                      kp_uv, kp_cov2_inv, kp_valid, K_intr, bounds, *,
                      radius, n_retry_th):
    _, proj, _, zs = _project(Tcw_pred, mp_pos, K_intr)
    depth_ok = 1.0 / zs > 0

    def run(rad):
        return matching.search_by_projection_frame(
            mp_desc_track, proj, depth_ok, mp_valid, kp_desc, kp_uv,
            kp_valid, torch.ones_like(kp_valid), radius=rad, bounds=bounds)

    m1, inv1 = run(radius)
    _, inv2 = run(2.0 * radius)
    thin = (m1 >= 0).sum() < n_retry_th  # widen the window when thin
    kp2mp = torch.where(thin, inv2, inv1)
    kp_has = kp2mp >= 0
    res = pose_opt.pose_optimization(
        Tcw_pred, mp_pos[kp2mp.clamp_min(0).long()], kp_uv, kp_cov2_inv,
        kp_has, K_intr)
    return dict(Tcw=res.Tcw, kp2mp=kp2mp, inlier=res.inlier,
                n_match=kp_has.sum(), n_inlier=res.n_inlier)


def reloc_track_body(T0s, mp_pos, mp_desc, mp_valid, kp_desc, kp_uv,
                     kp_cov2_inv, kp_valid, K_intr, bounds, *,
                     radius2: float = 10.0):
    """Relocalization attempt against one candidate keyframe: brute-force
    mutual NN + pose optimization from a fan of S starts (one batched LM,
    the start with the most inliers kept) + the windowed second chance with
    the fitted pose, kept when it does not lose inliers."""
    kp2mp = matching.search_by_brute_force(mp_desc, mp_valid, kp_desc,
                                           kp_valid)
    kp_has = kp2mp >= 0
    Xw = mp_pos[kp2mp.clamp_min(0).long()]
    res = pose_opt.pose_optimization(T0s, Xw, kp_uv, kp_cov2_inv, kp_has,
                                     K_intr)
    best = torch.argmax(res.n_inlier)
    Tfit = res.Tcw[best]
    n_fit = res.n_inlier[best]

    # windowed second chance with the fitted pose
    _, proj, _, zs = _project(Tfit, mp_pos, K_intr)
    mp_found = _scatter_flags(mp_pos.shape[0], kp2mp)
    _, kp2mp2 = matching.search_by_projection_frame(
        mp_desc, proj, 1.0 / zs > 0, mp_valid & ~mp_found, kp_desc, kp_uv,
        kp_valid, ~kp_has, radius=radius2, bounds=bounds)
    kp2mp_u = torch.where(kp_has, kp2mp, kp2mp2)
    kp_has_u = kp2mp_u >= 0
    res2 = pose_opt.pose_optimization(
        Tfit, mp_pos[kp2mp_u.clamp_min(0).long()], kp_uv, kp_cov2_inv,
        kp_has_u, K_intr)
    keep2 = res2.n_inlier >= n_fit
    return dict(
        Tcw=torch.where(keep2, res2.Tcw, Tfit),
        kp2mp=torch.where(keep2, kp2mp_u, kp2mp),
        inlier=torch.where(keep2, res2.inlier, res.inlier[best]),
        n_match=torch.where(keep2, kp_has_u, kp_has).sum(),
        n_inlier=torch.maximum(res2.n_inlier, n_fit))


def ref_track_body(Tcw0, mp_pos, mp_desc, mp_valid, kp_desc, kp_uv,
                   kp_cov2_inv, kp_valid, K_intr):
    kp2mp = matching.search_by_brute_force(mp_desc, mp_valid, kp_desc,
                                           kp_valid)
    kp_has = kp2mp >= 0
    res = pose_opt.pose_optimization(
        Tcw0, mp_pos[kp2mp.clamp_min(0).long()], kp_uv, kp_cov2_inv, kp_has,
        K_intr)
    return dict(Tcw=res.Tcw, kp2mp=kp2mp, inlier=res.inlier,
                n_match=kp_has.sum(), n_inlier=res.n_inlier)


def local_map_track_body(Tcw0, mp_pos, mp_desc_track, mp_normal, mp_valid,
                         mp_skip, kp2mp0, kp_desc, kp_uv, kp_cov2_inv,
                         kp_valid, K_intr, bounds, *, view_cos_th, window_th,
                         match_adaptive, c2_thresh):
    """SearchLocalPoints + PoseOptimization (tracker.cpp:561-832).  mp_skip:
    points already bound to the frame; kp2mp0: bindings carried in from the
    coarse stage (local-map indices, -1 free).  No scale-invariance
    distance gate: the reference comments it out of isInFrustum
    (frame.cpp:354-358)."""
    R, t = Tcw0[:3, :3], Tcw0[:3, 3]
    _, proj, z, _ = _project(Tcw0, mp_pos, K_intr)
    po = mp_pos - (-R.T @ t)
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = (po * mp_normal).sum(-1) / dist.clamp_min(1e-9)
    in_frustum = ((z > 0)
                  & (proj[:, 0] >= bounds[0]) & (proj[:, 0] <= bounds[1])
                  & (proj[:, 1] >= bounds[2]) & (proj[:, 1] <= bounds[3])
                  & (view_cos >= view_cos_th))
    to_match = mp_valid & ~mp_skip & in_frustum
    _, kp2mp_new = matching.search_by_projection_points(
        mp_desc_track, proj, view_cos, to_match, kp_desc, kp_uv, kp_valid,
        kp_valid & (kp2mp0 < 0), th=window_th,
        match_adaptive=match_adaptive, c2_thresh=c2_thresh)
    kp2mp = torch.where(kp2mp0 >= 0, kp2mp0, kp2mp_new.long())
    kp_has = kp2mp >= 0
    res = pose_opt.pose_optimization(
        Tcw0, mp_pos[kp2mp.clamp_min(0)], kp_uv, kp_cov2_inv, kp_has, K_intr)
    return dict(Tcw=res.Tcw, kp2mp=kp2mp, inlier=res.inlier,
                n_extra=(kp2mp_new >= 0).sum(), n_inlier=res.n_inlier,
                mp_visible=to_match)


def fused_track_body(Tcw_pred, dust_pos, dust_desc_track, dust_valid, dust,
                     occ_grid, loc_pos, loc_desc_track, loc_normal, loc_valid,
                     dust2local, kp_desc, kp_uv, kp_cov2_inv, kp_valid,
                     K_intr, bounds, *, dust_iters, huber_delta, chi2_inlier,
                     view_cos_th, window_th, match_adaptive, c2_thresh):
    """The OK-path chain in one stage: dust_track_body flowing into
    local_map_track_body, with the coarse -> fine binding handoff on the
    device.  The host speculates the local-map candidate set from the
    previous frame's bindings and passes `dust2local` (dust-candidate index
    -> local-map index or -1); kp2mp0 and the skip mask are derived here
    exactly as prepare_local_map would."""
    d = dust_track_body(Tcw_pred, dust_pos, dust_desc_track, dust_valid,
                        dust, occ_grid, kp_desc, kp_uv, kp_cov2_inv,
                        kp_valid, K_intr, dust_iters=dust_iters,
                        huber_delta=huber_delta, chi2_inlier=chi2_inlier)
    kp2mp_dust = d["kp2mp"]
    kp2mp0 = torch.where(kp2mp_dust >= 0,
                         dust2local[kp2mp_dust.clamp_min(0).long()], -1)
    skip = _scatter_flags(loc_pos.shape[0], kp2mp0)
    f = local_map_track_body(
        d["Tcw"], loc_pos, loc_desc_track, loc_normal, loc_valid, skip,
        kp2mp0, kp_desc, kp_uv, kp_cov2_inv, kp_valid, K_intr, bounds,
        view_cos_th=view_cos_th, window_th=window_th,
        match_adaptive=match_adaptive, c2_thresh=c2_thresh)
    out = {"d_" + k: v for k, v in d.items()}
    out.update({"l_" + k: v for k, v in f.items()})
    out["skip"] = skip
    out["kp2mp0"] = kp2mp0
    return out


Draws = Union[torch.Tensor, np.ndarray, Callable[[int], object]]


def init_body(kp1_desc, kp1_uv, kp1_valid, prev_uv, kp2_desc, kp2_uv,
              kp2_valid, K_intr, draws: Draws, *, window, ratio):
    """SearchForInitialization (window 100, ratio 0.9) + Initializer::
    Initialize.  `draws`: the RANSAC sample positions (iters, 8), or a
    callable taking the match count and returning them (read back once)."""
    m12, n, _ = cuda_match.match_init_batch(
        kp1_desc[None], kp1_valid[None], prev_uv[None], kp2_desc[None],
        kp2_uv[None], kp2_valid[None], window=window, ratio=ratio)
    m12, n = m12[0], n[0]
    if callable(draws):
        draws = draws(int(n))
    draws = torch.as_tensor(np.asarray(draws) if not isinstance(
        draws, torch.Tensor) else draws, device=kp1_uv.device)
    has = m12 >= 0
    res = twoview.initialize(kp1_uv, kp2_uv[m12.clamp_min(0).long()], has,
                             K_intr, draws)
    return dict(ok=res.ok, used_h=res.used_h, R21=res.R21, t21=res.t21,
                points=res.points, triangulated=res.triangulated & has,
                match12=m12, n_matches=n)


def _kmat(K_intr):
    Km = torch.eye(3, dtype=K_intr.dtype, device=K_intr.device)
    Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2] = (K_intr[0], K_intr[1],
                                              K_intr[2], K_intr[3])
    return Km


def triangulate_body(Tcw1, Tcw2, kp1_uv, kp1_desc, kp1_cov2_inv, kp1_free,
                     kp2_uv, kp2_desc, kp2_cov2_inv, kp2_free, K_intr, *,
                     nn_ratio, method: int = 1, seed_px_noise: float = 1.0):
    """One neighbour-KF triangulation pass (local_mapper.cpp:615-791):
    SearchForTri (method 1: exact 2-NN + epipole + epipolar gates, the
    FLANN equivalent; method 2: the epipolar-segment walk,
    SearchForTriByEpi; dispatch at local_mapper.cpp:623-631) -> DLT in
    normalized coordinates -> gates, plus each view's depth and its
    triangulation uncertainty for the depth filter.  KF1 = current KF,
    KF2 = neighbour."""
    fx, fy, cx, cy = K_intr[0], K_intr[1], K_intr[2], K_intr[3]
    R1, t1 = Tcw1[:3, :3], Tcw1[:3, 3]
    R2, t2 = Tcw2[:3, :3], Tcw2[:3, 3]
    # F12 = K^-T [t12]x R12 K^-1 (ComputeF12)
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    zero = torch.zeros_like(t12[0])
    t12x = torch.stack([torch.stack([zero, -t12[2], t12[1]]),
                        torch.stack([t12[2], zero, -t12[0]]),
                        torch.stack([-t12[1], t12[0], zero])])
    Kinv, _ = torch.linalg.inv_ex(_kmat(K_intr))
    F12 = Kinv.T @ t12x @ R12 @ Kinv
    # epipole of camera 1 in image 2
    C1_in_2 = R2 @ (-R1.T @ t1) + t2
    e2 = torch.stack([fx * C1_in_2[0] / C1_in_2[2] + cx,
                      fy * C1_in_2[1] / C1_in_2[2] + cy])
    if method == 2:
        match21 = matching.search_for_tri_by_epi(
            kp1_desc, kp1_uv, kp1_free, kp2_desc, kp2_uv, kp2_free, e2, F12,
            R2 @ R1.T, K_intr, kp2_cov2_inv)
    else:
        match21 = matching.search_for_triangulation(
            kp1_desc, kp1_free, kp1_free, kp2_desc, kp2_uv, kp2_free,
            kp2_free, e2, F12, kp1_uv, kp2_cov2_inv, ratio=nn_ratio)
    has = match21 >= 0
    idx1 = match21.clamp_min(0).long()
    uv1 = kp1_uv[idx1]

    def normalize(uv):
        return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)

    X = triangulate(Tcw1[:3, :], Tcw2[:3, :], normalize(uv1),
                    normalize(kp2_uv))
    gates = triangulation_gates(X, Tcw1, Tcw2, K_intr, uv1, kp2_uv,
                                kp1_cov2_inv[idx1], kp2_cov2_inv, has)
    O1 = -R1.T @ t1
    O2 = -R2.T @ t2
    px_err_angle = 2.0 * torch.atan(seed_px_noise / (2.0 * fx))
    z1, tau1 = depth_and_tau(X, O1, O2, px_err_angle)
    z2, tau2 = depth_and_tau(X, O2, O1, px_err_angle)
    return dict(match21=match21, points=X, good=gates.good,
                n_good=gates.good.sum(), z1=z1, tau1=tau1, z2=z2, tau2=tau2)


def fuse_body(Tcw, mp_pos, mp_desc, mp_normal, mp_dmin, mp_dmax, mp_valid,
              kp_uv, kp_desc, kp_valid, K_intr, bounds, *, radius):
    """The device part of SPMatcher::Fuse into one keyframe."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    _, proj, z, _ = _project(Tcw, mp_pos, K_intr)
    po = mp_pos - (-R.T @ t)
    dist3 = torch.linalg.vector_norm(po, dim=-1)
    view_ok = (po * mp_normal).sum(-1) >= 0.5 * dist3
    ok = (mp_valid & (z > 0)
          & (proj[:, 0] >= bounds[0]) & (proj[:, 0] <= bounds[1])
          & (proj[:, 1] >= bounds[2]) & (proj[:, 1] <= bounds[3])
          & (dist3 >= 0.8 * mp_dmin) & (dist3 <= 1.2 * mp_dmax) & view_ok)
    idx, best = matching.fuse_candidates(mp_desc, proj, ok, kp_desc, kp_uv,
                                         kp_valid, radius=radius)
    return dict(best_idx=idx, best_dist=best)


# ---------------------------------------------------------------------------
# host-facing stages
# ---------------------------------------------------------------------------


def _stage(fn):
    """Run a stage without autograd and with full-float32 matmuls."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode(), full_f32():
            return fn(*args, **kwargs)

    return wrapped


class TrackingKernels:
    """Config-bound stages on `device` (the card unless the caller passes
    "cpu"), each with one packed upload and one packed readback."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the tracking stages on the CPU")
        self.cfg = cfg
        self.device = dev
        # the stream mesh (parallel/mesh.Mesh) the batched stages split
        # over; None runs every batch on `device`
        self.batch_mesh = None
        # batched stage name -> how its last batch ran: n_rows, split,
        # slots and the devices of the chunks
        self.last_batch_placement: dict = {}
        K = cfg.runtime.max_keypoints
        P = cfg.runtime.dust_points_cap
        L = cfg.runtime.local_points_cap
        cam = cfg.camera
        self.K_np = np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
        self.K_intr = torch.from_numpy(self.K_np).to(dev)
        self.bounds = torch.tensor(
            [0.0, cam.width - 1.0, 0.0, cam.height - 1.0], device=dev)
        self._consts_on = {self.K_intr.device: (self.K_intr, self.bounds)}

        self.dust_layout = Layout([
            ("Tcw", (4, 4), float), ("Tcw_coarse", (4, 4), float),
            ("kp2mp", (K,), int), ("post_inlier", (K,), bool),
            ("n_coarse", (), int), ("n_match", (), int), ("n_opt", (), int),
            ("mp_in_view", (P,), bool), ("mp_matched", (P,), bool)])
        self.track_layout = Layout([
            ("Tcw", (4, 4), float), ("kp2mp", (K,), int),
            ("inlier", (K,), bool), ("n_match", (), int),
            ("n_inlier", (), int)])
        self.local_layout = Layout([
            ("Tcw", (4, 4), float), ("kp2mp", (K,), int),
            ("inlier", (K,), bool), ("n_extra", (), int),
            ("n_inlier", (), int), ("mp_visible", (L,), bool)])
        self.fused_layout = Layout(
            [("d_" + n, s, t) for n, s, t in self.dust_layout.specs]
            + [("l_" + n, s, t) for n, s, t in self.local_layout.specs]
            + [("skip", (L,), bool), ("kp2mp0", (K,), int)])
        self.init_layout = Layout([
            ("ok", (), bool), ("used_h", (), bool), ("R21", (3, 3), float),
            ("t21", (3,), float), ("points", (K, 3), float),
            ("triangulated", (K,), bool), ("match12", (K,), int),
            ("n_matches", (), int)])
        self.tri_layout = Layout([
            ("match21", (K,), int), ("points", (K, 3), float),
            ("good", (K,), bool), ("n_good", (), int),
            ("z1", (K,), float), ("tau1", (K,), float),
            ("z2", (K,), float), ("tau2", (K,), float)])
        self.fuse_layout = Layout([
            ("best_idx", (L,), int), ("best_dist", (L,), float)])
        hc, wc = cfg.grid_h, cfg.grid_w
        self.feat_layout = Layout([
            ("uv", (K, 2), float), ("score", (K,), float),
            ("response", (K,), float), ("valid", (K,), bool),
            ("cov2_inv", (K, 2), float), ("occ_grid", (hc, wc), int),
            ("count", (), int)])

        d = cfg.tracking.dust
        m = cfg.tracking.map
        self._dust_kw = dict(dust_iters=d.iters, huber_delta=d.huber_delta,
                             chi2_inlier=d.chi2_inlier)
        self._heat_kw = dict(heat_iters=d.iters, huber_delta=d.huber_delta,
                             chi2_inlier=cfg.tracking.heat_chi2_inlier)
        # triangulation rows dispatched, by matching_method (the online
        # fleet's mapping threads share these stages: counted under a lock)
        self.tri_rows = collections.Counter()
        self._tri_lock = threading.Lock()
        self._local_kw = dict(view_cos_th=m.th_view_cos,
                              match_adaptive=m.match_adaptive,
                              c2_thresh=d.c2_thresh)

    # ---- transfers ---------------------------------------------------------

    def _up(self, args) -> list:
        return upload(args, self.device)

    @staticmethod
    def _read(layout: Layout, flat: torch.Tensor) -> dict:
        return layout.unpack(flat.cpu().numpy())

    def _feat_flat(self, uv, score, response, valid, cov2_inv, occ_grid,
                   count):
        return self.feat_layout.pack(
            uv=uv, score=score, response=response, valid=valid,
            cov2_inv=cov2_inv, occ_grid=occ_grid, count=count)

    @staticmethod
    def _host_mirrors(out: dict) -> dict:
        for k in ("uv", "score", "response", "cov2_inv"):
            out[k] = out[k].astype(np.float32)
        out["occ_grid"] = out["occ_grid"].astype(np.int32)
        return out

    def fetch_features_host(self, feats, b: int = 0) -> dict:
        """One packed copy of a frame's host mirrors."""
        return self._fetch_rows(feats, slice(b, b + 1))[0]

    def fetch_features_host_batch(self, feats, n: int) -> List[dict]:
        """The host mirrors of rows 0..n-1 of a batched extraction in ONE
        packed copy (the fleet's per-tick feature readback)."""
        return self._fetch_rows(feats, slice(0, n))

    @_stage
    def _fetch_rows(self, feats, rows: slice) -> List[dict]:
        with span("readback"):
            with span("readback/pack"):
                flat = torch.func.vmap(self._feat_flat)(
                    feats.uv[rows], feats.score[rows], feats.response[rows],
                    feats.valid[rows], feats.cov2_inv[rows],
                    feats.occ_grid[rows], feats.count[rows])
            with span("readback/copy"):
                flat = flat.cpu().numpy()
            with span("readback/unpack"):
                return [self._host_mirrors(self.feat_layout.unpack(r))
                        for r in flat]

    @_stage
    def gather_rows(self, bank, rows, valid) -> torch.Tensor:
        """On-device descriptor row gather: (cap, 256) device bank + (P,)
        rows / valid -> (P, 256) device tensor (invalid slots exact
        zeros)."""
        bank, rows, valid = self._up((bank, rows, valid))
        return torch.where(valid[:, None], bank[rows], 0.0)

    def _consts(self, dev: torch.device):
        """(K_intr, bounds) on `dev`: a mesh slot's chunk runs there."""
        c = self._consts_on.get(dev)
        if c is None:
            c = self._consts_on[dev] = (self.K_intr.to(dev),
                                        self.bounds.to(dev))
        return c

    def _placement(self, stage: str, n: int) -> list:
        """(device, lo, hi) chunks of an n-row batch: one per mesh slot when
        `batch_mesh` is set and its slot count divides n, else the whole
        batch on the kernels' device; recorded in last_batch_placement."""
        mesh = self.batch_mesh
        split = mesh is not None and n % mesh.size == 0
        parts = mesh.split(n) if split else [(self.K_intr.device, 0, n)]
        self.last_batch_placement[stage] = dict(
            n_rows=n, split=split, slots=len(parts),
            devices=[str(d) for d, _, _ in parts])
        return parts

    def _batch(self, fn, layout: Layout, rows, bank: bool = False,
               desc_idx: int = 2, valid_idx: int = 3, *,
               stage: str) -> List[dict]:
        """`fn` (a stage of device tensors returning a dict) over the
        per-row argument tuples `rows` under torch.func.vmap: ONE packed
        upload of every row's host arguments, ONE packed readback (one of
        each per mesh slot when the batch is split).  With `bank` the
        descriptor slot holds bank-row indices and each row ends with the
        stacked descriptor banks (BankRows).  A split chunk's arguments
        move to its slot's device, the maps' descriptor banks included:
        they live on the kernels' device and are copied each batch to a
        slot on another device (nothing moves on one card; per-slot bank
        mirrors are what a multi-card deployment would add first)."""
        if bank:
            fn = _bank_variant(fn, desc_idx, valid_idx)
        run = torch.func.vmap(lambda *a: layout.pack(**fn(*a)))
        # every chunk is enqueued before any readback, so slots on
        # different cards run at once
        flats = [run(*upload_rows(_row_chunk(rows, lo, hi), d))
                 for d, lo, hi in self._placement(stage, len(rows))]
        return [layout.unpack(r) for f in flats for r in f.cpu().numpy()]

    def _batch_chunked(self, fn, layout: Layout, rows, stage: str,
                       max_width: int = 8) -> List[dict]:
        """The mapper's batches: chunks of at most `max_width` rows, one
        upload and one readback each (a single row runs unbatched), so the
        vmapped working set stays bounded."""
        outs = []
        for i in range(0, len(rows), max_width):
            chunk = rows[i:i + max_width]
            if len(chunk) == 1:
                outs.append(self._read(layout,
                                       layout.pack(**fn(*self._up(chunk[0])))))
            else:
                outs.extend(self._batch(fn, layout, chunk, stage=stage))
        return outs

    # ---- stage functions of device tensors ---------------------------------
    # (each takes the constants on its arguments' device: a mesh slot's)

    def _dust_fn(self, *a):
        K_intr, _ = self._consts(a[0].device)
        return dust_track_body(*a, K_intr, **self._dust_kw)

    def _heat_fn(self, *a):
        K_intr, _ = self._consts(a[0].device)
        return heat_track_body(*a, K_intr, **self._heat_kw)

    def _motion_fn(self, *a):
        mo = self.cfg.tracking.motion
        return motion_track_body(*a, *self._consts(a[0].device),
                                 radius=float(mo.th_window_size),
                                 n_retry_th=mo.th_nmatch_proj)

    def _reloc_fn(self, *a):
        return reloc_track_body(
            *a, *self._consts(a[0].device),
            radius2=float(self.cfg.tracking.map.th_window_reloc))

    def _local_fn(self, wide: bool):
        m = self.cfg.tracking.map
        window_th = float(m.th_window_retry if wide else m.th_window_size)
        return lambda *a: local_map_track_body(
            *a, *self._consts(a[0].device), window_th=window_th,
            **self._local_kw)

    def _tri_fn(self, *a):
        mp = self.cfg.mapping
        K_intr, _ = self._consts(a[0].device)
        return triangulate_body(*a, K_intr, nn_ratio=0.7,
                                method=mp.matching_method,
                                seed_px_noise=mp.depth_filter.seed_px_noise)

    def _fuse_fn(self, *a):
        return fuse_body(*a, *self._consts(a[0].device), radius=3.0)

    # ---- tracking ----------------------------------------------------------

    @_stage
    def dust_track(self, *args):
        return self._read(self.dust_layout,
                          self.dust_layout.pack(**self._dust_fn(
                              *self._up(args))))

    @_stage
    def heat_track(self, *args):
        """The heat coarse stage (coarse_method "heat"): dust_track's
        arguments with the frame's full-resolution heat map (H, W) in place
        of its dust map, dust_track's fields."""
        return self._read(self.dust_layout,
                          self.dust_layout.pack(**self._heat_fn(
                              *self._up(args))))

    @_stage
    def dust_track_batch(self, rows, bank: bool = False) -> List[dict]:
        """The dust stage over per-stream argument tuples (the fleet's
        prepass): one upload, one readback for the whole fleet."""
        return self._batch(self._dust_fn, self.dust_layout, rows, bank,
                           stage="dust")

    @_stage
    def fused_track(self, *args, wide: bool = False):
        """One-stage OK path; returns (dust_out, local_out) in the
        dust_track / local_map_track field layouts, plus the device-side
        glue masks under local_out["skip"] / ["kp2mp0"]."""
        m = self.cfg.tracking.map
        a = self._up(args)
        out = fused_track_body(
            *a, self.K_intr, self.bounds, **self._dust_kw, **self._local_kw,
            window_th=float(m.th_window_retry if wide else m.th_window_size))
        flat = self._read(self.fused_layout, self.fused_layout.pack(**out))
        dust_out = {n: flat["d_" + n] for n, _, _ in self.dust_layout.specs}
        local_out = {n: flat["l_" + n]
                     for n, _, _ in self.local_layout.specs}
        local_out["skip"] = flat["skip"]
        local_out["kp2mp0"] = flat["kp2mp0"]
        return dust_out, local_out

    @_stage
    def motion_track(self, *args):
        return self._read(self.track_layout, self.track_layout.pack(
            **self._motion_fn(*self._up(args))))

    @_stage
    def motion_track_batch(self, rows, bank: bool = False) -> List[dict]:
        """The motion-model fallback of every stream whose dust stage
        failed this tick (the fleet's coarse_phase2)."""
        return self._batch(self._motion_fn, self.track_layout, rows, bank,
                           stage="motion")

    @_stage
    def ref_track(self, *args):
        out = ref_track_body(*self._up(args), self.K_intr)
        return self._read(self.track_layout, self.track_layout.pack(**out))

    @_stage
    def reloc_track(self, *args):
        return self._read(self.track_layout, self.track_layout.pack(
            **self._reloc_fn(*self._up(args))))

    @_stage
    def reloc_track_batch(self, rows, bank: bool = False) -> List[dict]:
        """The multi-start rescue of the fleet's fine retry rounds."""
        return self._batch(self._reloc_fn, self.track_layout, rows, bank,
                           stage="reloc")

    @_stage
    def local_map_track(self, *args):
        return self._read(self.local_layout, self.local_layout.pack(
            **self._local_fn(False)(*self._up(args))))

    @_stage
    def local_map_track_wide(self, *args):
        """Starvation retry at the widened window (th_window_retry)."""
        return self._read(self.local_layout, self.local_layout.pack(
            **self._local_fn(True)(*self._up(args))))

    @_stage
    def local_map_track_batch(self, rows, wide: bool = False,
                              bank: bool = False) -> List[dict]:
        """The fine stage over per-stream argument tuples (the fleet's
        local prepass and its wide retries)."""
        return self._batch(self._local_fn(wide), self.local_layout, rows,
                           bank, desc_idx=2, valid_idx=4,
                           stage="local_wide" if wide else "local")

    @_stage
    def init_two_view(self, kp1_desc, kp1_uv, kp1_valid, prev_uv, kp2_desc,
                      kp2_uv, kp2_valid, draws: Draws):
        a = self._up((kp1_desc, kp1_uv, kp1_valid, prev_uv, kp2_desc,
                      kp2_uv, kp2_valid))
        out = init_body(*a, self.K_intr, draws, window=100, ratio=0.9)
        return self._read(self.init_layout, self.init_layout.pack(**out))

    # ---- mapping -----------------------------------------------------------

    @_stage
    def triangulate_pair_batch(self, rows):
        """Every neighbour row's triangulation, one packed upload and
        readback per chunk of 8 rows."""
        with self._tri_lock:
            self.tri_rows[self.cfg.mapping.matching_method] += len(rows)
        return self._batch_chunked(self._tri_fn, self.tri_layout, rows,
                                   "tri")

    @_stage
    def fuse(self, *args):
        return self._read(self.fuse_layout, self.fuse_layout.pack(
            **self._fuse_fn(*self._up(args))))

    @_stage
    def fuse_batch(self, rows):
        """Every target-KF row's fuse candidates, one packed upload and
        readback per chunk of 8 rows."""
        return self._batch_chunked(self._fuse_fn, self.fuse_layout, rows,
                                   "fuse")

    # ---- warmup ------------------------------------------------------------

    def warmup(self, pool_capacity: int = 4096, ba: bool = True) -> None:
        """Run every single-stream stage once at its production shapes on
        dummy inputs (JAX TrackingKernels.warmup): the descriptor gathers,
        dust (heat under coarse_method "heat"), fused and fused-wide (dust
        only), motion, ref, reloc at the keypoint and
        the local-map caps, local and local-wide, init, triangulation and
        fuse (alone and batched) and, with `ba`, the local BA at its caps
        and the init-time global BA at its smallest power-of-two sizes.
        The card's kernel builds, the CUDA libraries' loads and the
        allocator's first blocks then leave the first frames.  The inputs
        are degenerate (zeros, a few valid entries): only shapes count."""
        cfg = self.cfg
        K = cfg.runtime.max_keypoints
        P = cfg.runtime.dust_points_cap
        L = cfg.runtime.local_points_cap
        hc, wc = cfg.grid_h, cfg.grid_w
        dev = self.device
        eye = np.eye(4, dtype=np.float32)

        def val(n):
            v = np.zeros(n, bool)
            v[:4] = True
            return v

        val_k, val_d, val_l = val(K), val(P), val(L)
        uv = np.zeros((K, 2), np.float32)
        cov = np.ones((K, 2), np.float32)
        pos_d = np.zeros((P, 3), np.float32)
        pos_l = np.zeros((L, 3), np.float32)
        pos_k = np.zeros((K, 3), np.float32)
        normal_l = np.zeros((L, 3), np.float32)
        dust = torch.zeros((hc, wc), device=dev)
        occ = torch.full((hc, wc), -1, dtype=torch.int32, device=dev)
        desc_k = torch.zeros((K, 256), device=dev)
        # the gathers on their production (bank, rows) shapes: the pool bank
        # into dust / local rows, a keyframe's descriptors into its
        # observation rows (the ref-KF and reloc paths)
        bank = torch.zeros((pool_capacity, 256), device=dev)
        desc_p = self.gather_rows(bank, np.zeros(P, np.int32), val_d)
        desc_l = self.gather_rows(bank, np.zeros(L, np.int32), val_l)
        desc_kf = self.gather_rows(desc_k, np.zeros(K, np.int32), val_k)

        if cfg.tracking.coarse_method == "heat":
            heat = torch.zeros((cfg.camera.height, cfg.camera.width),
                               device=dev)
            self.heat_track(eye, pos_d, desc_p, val_d, heat, occ, desc_k, uv,
                            cov, val_k)
        else:
            self.dust_track(eye, pos_d, desc_p, val_d, dust, occ, desc_k,
                            uv, cov, val_k)
        self.motion_track(eye, pos_l, desc_l, val_l, desc_k, uv, cov, val_k)
        self.ref_track(eye, pos_k, desc_kf, val_k, desc_k, uv, cov, val_k)
        T0s = np.tile(eye, (16, 1, 1))
        self.reloc_track(T0s, pos_k, desc_kf, val_k, desc_k, uv, cov, val_k)
        # the local map's multi-start rescue: the reloc stage at the
        # local-map cap
        self.reloc_track(T0s, pos_l, desc_l, val_l, desc_k, uv, cov, val_k)
        largs = (eye, pos_l, desc_l, normal_l, val_l, np.zeros(L, bool),
                 np.full(K, -1, np.int64), desc_k, uv, cov, val_k)
        self.local_map_track(*largs)
        self.local_map_track_wide(*largs)
        if cfg.tracking.fused_ok_path and cfg.tracking.coarse_method == "dust":
            fargs = (eye, pos_d, desc_p, val_d, dust, occ, pos_l, desc_l,
                     normal_l, val_l, np.full(P, -1, np.int32), desc_k, uv,
                     cov, val_k)
            self.fused_track(*fargs, wide=False)
            self.fused_track(*fargs, wide=True)
        self.init_two_view(desc_k, uv, val_k, uv, desc_k, uv, val_k,
                           torch.zeros((cfg.runtime.init_ransac_iters, 8),
                                       dtype=torch.long))
        tri_row = (eye, eye, uv, desc_k, cov, val_k, uv, desc_k, cov, val_k)
        fuse_row = (eye, pos_l, desc_l, normal_l, np.zeros(L, np.float32),
                    np.zeros(L, np.float32), val_l, uv, desc_k, val_k)
        self.fuse(*fuse_row)
        # the mapper's batches: one row runs unbatched, more under vmap in
        # chunks of up to 8
        for w in (1, 2, 8):
            self.triangulate_pair_batch([tri_row] * w)
            self.fuse_batch([fuse_row] * w)
        if not ba:
            return
        from sp_orb_slam_tpu_torch.slam.local_mapping import _solve_ba

        rt = cfg.runtime

        def problem(C, P, O, fixed):
            return (np.tile(eye, (C, 1, 1)), fixed,
                    np.zeros((P, 3), np.float32), np.zeros(P, bool),
                    np.zeros(O, np.int32), np.zeros(O, np.int32),
                    np.zeros((O, 2), np.float32), np.ones((O, 2), np.float32),
                    np.zeros(O, bool))

        # the mapper's local BA at its caps, then the init-time global BA
        # at its likely power-of-two sizes
        C = rt.ba_kfs_cap
        _solve_ba(self, problem(C, rt.ba_points_cap, rt.ba_obs_cap,
                                np.ones(C, bool)),
                  iters1=5, iters2=10, two_phase=True, robust=True)
        for Pb, Ob in ((128, 256), (256, 512), (512, 1024), (1024, 2048)):
            _solve_ba(self, problem(2, Pb, Ob, np.asarray([True, False])),
                      iters1=20, two_phase=False, robust=True)
