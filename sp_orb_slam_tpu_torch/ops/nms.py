"""Grid NMS + occupancy-grid construction, batched over images.

Reference semantics (src/cv/sp_extractor.cpp:161-250, call site :489-503),
as in the JAX package's ops/nms.py:

1. candidates = per-8x8-cell argmax pixels with score >= 0.007 (from the
   frontend), sorted by score descending;
2. greedy NMS in score order with a square +-4 px suppression window; stops
   after `num_features`+1 survivors;
3. survivors are re-emitted in raster order, dropping any within `border`
   px of the image edge; the emission order defines the keypoint indices;
4. `occ_grid` (hc, wc) stores the keypoint index per cell (-1 when empty).

Greedy NMS is the commit/reject fixed point over the 3x3 cell neighbourhood
(`greedy_grid_nms`; the kernel in ops/cuda_nms.py runs the same rounds), and
the emission is a cumsum + one sort.  Every function takes a leading batch
dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint sets for B images (capacity K)."""

    uv: torch.Tensor        # (B, K, 2) float32 pixel coords, raster order
    score: torch.Tensor     # (B, K) frontend cell score
    valid: torch.Tensor     # (B, K) bool
    cell: torch.Tensor      # (B, K) flat cell index (v_c * wc + u_c), -1 invalid
    occ_grid: torch.Tensor  # (B, hc, wc) int32 keypoint index per cell, -1 empty
    count: torch.Tensor     # (B,) int32 number of valid keypoints


_DIRS = [(dv, du) for dv in (-1, 0, 1) for du in (-1, 0, 1)
         if (dv, du) != (0, 0)]


def _shift2d(x: torch.Tensor, dv: int, du: int, fill) -> torch.Tensor:
    """out[:, r, c] = x[:, r + dv, c + du], `fill` outside the grid."""
    hc, wc = x.shape[-2:]
    p = F.pad(x[:, None].float() if x.dtype == torch.bool else x[:, None],
              (1, 1, 1, 1), value=fill)[:, 0]
    out = p[:, 1 + dv:1 + dv + hc, 1 + du:1 + du + wc]
    return out > 0 if x.dtype == torch.bool else out


def greedy_grid_nms(score: torch.Tensor, cand_uv: torch.Tensor,
                    cand_valid: torch.Tensor, *, dist: int = 4,
                    iters: int = 16) -> torch.Tensor:
    """Exact greedy score-order NMS over per-cell candidates.

    score (B, hc, wc); cand_uv (B, hc, wc, 2) int pixel coords; cand_valid
    bool.  Returns the survivor mask (B, hc, wc).  Priority = score desc,
    ties broken by flat cell index asc."""
    B, hc, wc = score.shape
    dev = score.device
    flat = torch.arange(hc * wc, dtype=torch.int32, device=dev).view(1, hc, wc)
    flat = flat.expand(B, hc, wc)
    u = cand_uv[..., 0].to(torch.int32)
    v = cand_uv[..., 1].to(torch.int32)
    conflict, hp = [], []
    for dv, du in _DIRS:
        n_valid = _shift2d(cand_valid, dv, du, 0)
        n_u = _shift2d(u, dv, du, 10 ** 6)
        n_v = _shift2d(v, dv, du, 10 ** 6)
        n_s = _shift2d(score, dv, du, float("-inf"))
        n_i = _shift2d(flat, dv, du, -1)
        conflict.append(((n_u - u).abs() <= dist) & ((n_v - v).abs() <= dist)
                        & n_valid)
        hp.append((n_s > score) | ((n_s == score) & (n_i < flat)))
    kept = torch.zeros_like(cand_valid)
    rejected = torch.zeros_like(cand_valid)
    for _ in range(iters):
        undecided = cand_valid & ~kept & ~rejected
        all_hp_rejected = torch.ones_like(kept)
        any_kept_conflict = torch.zeros_like(kept)
        for (dv, du), cf, h in zip(_DIRS, conflict, hp):
            n_kept = _shift2d(kept, dv, du, 0)
            n_rej = _shift2d(rejected, dv, du, 0)
            # commit only when every conflicting higher-priority neighbour
            # is already rejected
            all_hp_rejected &= ~(cf & h & ~n_rej)
            any_kept_conflict |= cf & n_kept
        kept = kept | (undecided & all_hp_rejected)
        rejected = rejected | (undecided & any_kept_conflict)
    return kept


def _at(x: torch.Tensor, i: int) -> torch.Tensor:
    """x[:, i] with the index clamped into range (the JAX package indexes
    with XLA's clamping gather): a basic index, so nothing is uploaded."""
    return x[:, min(max(i, 0), x.shape[1] - 1)]


def select_keypoints(score: torch.Tensor, cand_uv: torch.Tensor,
                     cand_valid: torch.Tensor, *, num_features: int,
                     max_keypoints: int, image_hw: tuple[int, int],
                     dist: int = 4, border: int = 8, nms_iters: int = 16,
                     alive: torch.Tensor | None = None) -> Keypoints:
    """NMS -> score cap -> border filter -> raster-order emission + occ_grid
    for a batch (the JAX package's `emission="sort"` lowering).

    `alive` optionally injects a precomputed NMS survivor mask (the kernel
    path, ops/cuda_nms.py)."""
    H, W = image_hw
    B, hc, wc = score.shape
    K = max_keypoints
    n_cells = hc * wc
    dev = score.device
    if num_features + 1 > K:
        raise ValueError(f"num_features + 1 ({num_features + 1}) must be <= "
                         f"max_keypoints ({K})")
    if alive is None:
        alive = greedy_grid_nms(score, cand_uv, cand_valid, dist=dist,
                                iters=nms_iters)

    # score-order cap at num_features+1 (sp_extractor.cpp:210-213), before
    # the border filter: keep the top `cap` cells by (score desc, flat asc)
    cap = num_features + 1
    flat_score = torch.where(alive, score, float("-inf")).reshape(B, -1)
    flat_idx = torch.arange(n_cells, dtype=torch.int32, device=dev)
    sv = _at(torch.sort(flat_score, dim=1, descending=True).values, cap - 1)
    n_above = (flat_score > sv[:, None]).sum(1, dtype=torch.int32)
    r = cap - n_above                                   # tie slots left at sv
    tie_idx = torch.where(flat_score == sv[:, None], flat_idx, n_cells)
    tie_sorted = torch.sort(tie_idx, dim=1).values
    idx_thr = torch.gather(tie_sorted, 1, (r - 1).clamp(0, n_cells - 1)
                           .long()[:, None])[:, 0]
    capped_flat = (flat_score > sv[:, None]) | (
        (flat_score == sv[:, None]) & (r[:, None] > 0)
        & (flat_idx <= idx_thr[:, None]))
    capped = alive & capped_flat.reshape(B, hc, wc)

    u = cand_uv[..., 0]
    v = cand_uv[..., 1]
    in_border = (u >= border) & (u < W - border) & (v >= border) & (
        v < H - border)
    sel_flat = (capped & in_border).reshape(B, -1)

    # raster-order emission: slot s holds the s-th selected cell, so one
    # ascending sort of (selected ? cell : n_cells) is the slot->cell table
    slots = torch.cumsum(sel_flat.to(torch.int32), dim=1, dtype=torch.int32) - 1
    n = sel_flat.sum(1, dtype=torch.int32)
    occ_grid = torch.where(sel_flat, slots, -1).to(torch.int32).reshape(
        B, hc, wc)
    cells = torch.sort(torch.where(sel_flat, flat_idx, n_cells), dim=1).values
    if n_cells < K:  # tiny images: fewer cells than slots
        cells = F.pad(cells, (0, K - n_cells), value=n_cells)
    cells = cells[:, :K]
    valid_out = torch.arange(K, device=dev)[None, :] < n[:, None]
    safe = cells.clamp(0, n_cells - 1).long()
    uv_flat = cand_uv.reshape(B, -1, 2).to(torch.float32)
    uv_out = torch.where(valid_out[..., None], torch.gather(
        uv_flat, 1, safe[..., None].expand(B, K, 2)), 0.0)
    score_out = torch.where(valid_out, torch.gather(
        score.reshape(B, -1), 1, safe), 0.0)
    cell_out = torch.where(valid_out, safe.to(torch.int32), -1)
    return Keypoints(uv_out, score_out, valid_out, cell_out, occ_grid, n)


def greedy_grid_nms_reference(score, cand_uv, cand_valid, *, dist=4):
    """Sequential numpy golden model of the exact greedy NMS for one image
    (mirrors sp_extractor.cpp:194-214 without the cap)."""
    score = np.asarray(score)
    cand_uv = np.asarray(cand_uv)
    cand_valid = np.asarray(cand_valid)
    hc, wc = score.shape
    flat = [(-score[r, c], r * wc + c, r, c)
            for r in range(hc) for c in range(wc) if cand_valid[r, c]]
    flat.sort()
    taken = np.zeros((hc, wc), bool)
    suppressed = np.zeros((score.size,), bool)
    for _, idx, r, c in flat:
        if suppressed[idx]:
            continue
        taken[r, c] = True
        u0, v0 = cand_uv[r, c]
        for rr in range(max(0, r - 1), min(hc, r + 2)):
            for cc in range(max(0, c - 1), min(wc, c + 2)):
                if (rr, cc) == (r, c) or not cand_valid[rr, cc]:
                    continue
                u1, v1 = cand_uv[rr, cc]
                if (abs(int(u1) - int(u0)) <= dist
                        and abs(int(v1) - int(v0)) <= dist):
                    suppressed[rr * wc + cc] = True
    return taken
