"""Grid NMS and keypoint selection, plain PyTorch.

The reference extractor's rule (sp_extractor.cpp:161-250, the same as the
JAX package's and the port's plain `ops/nms.py`): each 8x8 cell offers its
argmax pixel when its score clears the threshold; greedy NMS in score
order (ties to the smaller flat cell index) suppresses any candidate
within +-dist px of a kept one, computed as the commit / reject fixed
point over the 3x3 cell neighbourhood for `iters` rounds; the survivors
are capped at `num_features` + 1 by score, those within `border` px of
the edge dropped, and the rest emitted in raster order.  A frozen copy,
so that the yardstick does not move with the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_DIRS = [(dv, du) for dv in (-1, 0, 1) for du in (-1, 0, 1)
         if (dv, du) != (0, 0)]


class Keypoints(NamedTuple):
    uv: torch.Tensor        # (N, K, 2) float32, raster order, 0 past count
    score: torch.Tensor     # (N, K)
    valid: torch.Tensor     # (N, K) bool
    occ_grid: torch.Tensor  # (N, hc, wc) int64 slot of each cell, -1 empty
    count: torch.Tensor     # (N,)


def _shift(x: torch.Tensor, dv: int, du: int, fill) -> torch.Tensor:
    """out[:, r, c] = x[:, r + dv, c + du], `fill` outside the grid."""
    hc, wc = x.shape[-2:]
    src = x.float() if x.dtype == torch.bool else x
    p = F.pad(src[:, None], (1, 1, 1, 1), value=fill)[:, 0]
    out = p[:, 1 + dv:1 + dv + hc, 1 + du:1 + du + wc]
    return out > 0 if x.dtype == torch.bool else out


def grid_nms(score, cand_uv, cand_valid, *, dist: int, iters: int):
    """The survivor mask (N, hc, wc) of the greedy grid NMS."""
    N, hc, wc = score.shape
    flat = torch.arange(hc * wc, device=score.device).view(1, hc, wc)
    flat = flat.expand(N, hc, wc)
    u = cand_uv[..., 0].long()
    v = cand_uv[..., 1].long()
    conflict, higher = [], []
    for dv, du in _DIRS:
        n_valid = _shift(cand_valid, dv, du, 0)
        n_u = _shift(u, dv, du, 10 ** 6)
        n_v = _shift(v, dv, du, 10 ** 6)
        n_s = _shift(score, dv, du, float("-inf"))
        n_i = _shift(flat, dv, du, -1)
        conflict.append(((n_u - u).abs() <= dist) & ((n_v - v).abs() <= dist)
                        & n_valid)
        higher.append((n_s > score) | ((n_s == score) & (n_i < flat)))
    kept = torch.zeros_like(cand_valid)
    rejected = torch.zeros_like(cand_valid)
    for _ in range(iters):
        undecided = cand_valid & ~kept & ~rejected
        clear = torch.ones_like(kept)
        blocked = torch.zeros_like(kept)
        for (dv, du), cf, h in zip(_DIRS, conflict, higher):
            clear &= ~(cf & h & ~_shift(rejected, dv, du, 0))
            blocked |= cf & _shift(kept, dv, du, 0)
        kept = kept | (undecided & clear)
        rejected = rejected | (undecided & blocked)
    return kept


def select(score, cand_uv, alive, *, num_features: int, max_keypoints: int,
           border: int) -> Keypoints:
    """Cap the survivors at num_features + 1 by (score desc, cell asc), drop
    the border, emit in raster order into K = max_keypoints slots."""
    N, hc, wc = score.shape
    H, W = hc * 8, wc * 8
    K = max_keypoints
    n_cells = hc * wc
    dev = score.device
    cap = num_features + 1
    flat_score = torch.where(alive, score, float("-inf")).reshape(N, -1)
    cells = torch.arange(n_cells, device=dev)
    # rank by (score desc, cell asc): a stable sort of the negated score
    order = torch.sort(-flat_score, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, cells.expand(N, -1).contiguous())
    capped = (alive.reshape(N, -1) & (rank < cap)).reshape(N, hc, wc)
    u = cand_uv[..., 0]
    v = cand_uv[..., 1]
    inside = (u >= border) & (u < W - border) & (v >= border) & (
        v < H - border)
    sel = (capped & inside).reshape(N, -1)
    slots = torch.cumsum(sel.long(), dim=1) - 1
    count = sel.sum(1)
    occ = torch.where(sel, slots, -1).reshape(N, hc, wc)
    raster = torch.sort(torch.where(sel, cells, n_cells), dim=1).values
    if n_cells < K:
        raster = F.pad(raster, (0, K - n_cells), value=n_cells)
    raster = raster[:, :K]
    valid = torch.arange(K, device=dev)[None, :] < count[:, None]
    safe = raster.clamp(0, n_cells - 1)
    uv = torch.gather(cand_uv.reshape(N, -1, 2).float(), 1,
                      safe[..., None].expand(N, K, 2))
    uv = torch.where(valid[..., None], uv, 0.0)
    sc = torch.where(valid, torch.gather(score.reshape(N, -1), 1, safe), 0.0)
    return Keypoints(uv, sc, valid, occ, count)
