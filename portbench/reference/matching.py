"""The initialisation matcher, plain PyTorch.

SearchForInitialization (sp_matcher.cpp:666-734): for each keypoint of the
previous frame, the nearest descriptor (L2 of unit rows, sqrt(2 - 2 a.b))
among the new frame's keypoints inside a square window of `window` px
around its old position (strict |du|, |dv| < window); kept when the best
is <= th and < ratio x the second best; each new keypoint then keeps its
closest claimant, ties to the smaller row.  Dot products in float32 with
TF32 off, unless `tf32` is set (the control).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.superpoint import tf32 as tf32_switch

BIG = 1e9


def distances(desc1: torch.Tensor, desc2: torch.Tensor,
              tf32: bool = False) -> torch.Tensor:
    """(N, M, D) x (N, P, D) unit rows -> (N, M, P) L2 distances."""
    with tf32_switch(tf32):
        dots = torch.matmul(desc1, desc2.transpose(-1, -2))
    return torch.sqrt((2.0 - 2.0 * dots).clamp_min(0.0))


def window_mask(uv1, valid1, uv2, valid2, window: float) -> torch.Tensor:
    du = (uv1[..., :, None, 0] - uv2[..., None, :, 0]).abs()
    dv = (uv1[..., :, None, 1] - uv2[..., None, :, 1]).abs()
    return ((du < window) & (dv < window) & valid1[..., :, None]
            & valid2[..., None, :])


class Decision(NamedTuple):
    """The matcher's intermediate values, for judging another's matches."""

    d: torch.Tensor        # (N, M, P) distances, BIG outside the window
    best: torch.Tensor     # (N, M)
    idx: torch.Tensor      # (N, M) the first nearest column
    second: torch.Tensor   # (N, M)
    row_ok: torch.Tensor   # (N, M) passes the threshold and the ratio
    claim: torch.Tensor    # (N, M, P) row_ok rows' claims on columns
    match12: torch.Tensor  # (N, M) the column kept, or -1


def decide(desc1, valid1, uv1, desc2, uv2, valid2, *, window: float,
           ratio: float, th: float, tf32: bool = False) -> Decision:
    dist = distances(desc1, desc2, tf32)
    d = torch.where(window_mask(uv1, valid1, uv2, valid2, window), dist, BIG)
    best, idx = d.min(-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == idx[..., None], BIG, d).amin(-1)
    row_ok = valid1 & (best <= th) & (best < ratio * second)
    M = idx.shape[-1]
    rows = torch.arange(M, device=d.device)
    claim = row_ok[..., None] & (idx[..., None] == cols)
    dmat = torch.where(claim, best[..., None], BIG)
    col_min = dmat.amin(-2)
    cand = claim & (dmat == col_min[..., None, :])
    winner_row = torch.where(cand, rows[:, None], M).amin(-2)
    won = row_ok & (torch.gather(winner_row, -1, idx) == rows)
    return Decision(d, best, idx, second, row_ok, claim,
                    torch.where(won, idx, -1))


def match(desc1, valid1, uv1, desc2, uv2, valid2, *, window: float,
          ratio: float, th: float, tf32: bool = False) -> torch.Tensor:
    """match12 (N, M): the new frame's keypoint for each old one, or -1."""
    return decide(desc1, valid1, uv1, desc2, uv2, valid2, window=window,
                  ratio=ratio, th=th, tf32=tf32).match12


def margins(dec: Decision, match12: torch.Tensor, *, ratio: float,
            th: float, out_of_window: float) -> torch.Tensor:
    """(N, M): for each row where `match12` differs from the reference's
    decision, how far the reference's distances lie from that decision's
    boundary; 0 where they agree.

    A column other than the row's nearest: its distance above the
    nearest's (`out_of_window` outside the window or on an invalid slot).
    The nearest column where the reference keeps none: the most by which
    one of its tests fails (best - th, best - ratio x second, best - the
    closest other claimant of the column).  No match where the reference
    keeps one: the least slack of the same three tests."""
    j = match12.clamp_min(0)
    dj = torch.gather(dec.d, -1, j[..., None])[..., 0]
    # the two closest claimants of each column, then for each row the
    # closest claimant of its nearest column other than itself
    claims = torch.where(dec.claim, dec.best[..., None], BIG)
    two = torch.topk(claims, min(2, claims.shape[-2]), dim=-2,
                     largest=False).values
    first = torch.gather(two[..., 0, :], -1, dec.idx)
    second = (torch.gather(two[..., 1, :], -1, dec.idx)
              if two.shape[-2] > 1 else torch.full_like(first, BIG))
    own = torch.gather(claims, -1, dec.idx[..., None])[..., 0]
    rival = torch.where(own == first, second, first)
    fail = torch.stack([dec.best - th, dec.best - ratio * dec.second,
                        dec.best - rival], -1).amax(-1)
    slack = torch.stack([th - dec.best, ratio * dec.second - dec.best,
                         rival - dec.best], -1).amin(-1)
    chose = match12 >= 0
    gap = torch.where(
        chose & (dj >= BIG), out_of_window,
        torch.where(chose & (j != dec.idx), dj - dec.best,
                    torch.where(chose, fail, slack).clamp_min(0)))
    return torch.where(match12 == dec.match12, 0.0, gap)
