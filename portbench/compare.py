"""The comparison that decides `correct`.

After the window, the plain reference (`portbench.reference`) is run over
the frames of a sample of the window's steps, drawn from the seed, and
each of the step's outputs is judged against it:

- the conv stack and the detector head: `dust_gap`, the widest gap of the
  dustbin logit map; `score_gap`, of each keypoint's cell score;
- the in-cell argmax: `kp_pixel_gap`, the widest gap by which the logit
  of a keypoint's pixel lies below the best of its cell in the reference;
- NMS, the cap, the border and the raster emission: `kp_set_diff`, the
  keypoint cells in one set and not the other over all judged frames, as
  a share of the reference's keypoints, with every slot that breaks the
  layout (count, order, occupancy grid, zeroed invalid slots) counted
  too;
- the heat map's normalisation: `resp_gap`, of each keypoint's response;
- the covariance fill: `cov_gap_p90` and `cov_gap_max`, the 90th
  percentile and the largest, over the keypoints, of the relative gap
  between a keypoint's covariance and the reference's fill at the same
  pixel (invalid slots must read 1);
- the descriptor sampling: `desc_gap`, the widest L2 distance between a
  slot's descriptor and the reference's at the same pixel (zero when
  invalid);
- the init matcher, run by the reference on the step's own features:
  `match_gap`, over the rows matched otherwise than the reference does,
  the widest margin by which the reference's distances lie from its own
  decision's boundary (`reference.matching.margins`); `match_diff`, the
  share of rows matched otherwise.

Each number read is held to the limit the cell's file gives it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import reference
from portbench.reference import covariance, descriptors, matching

OUT_OF_MASK = 2.0  # the gap of a match the reference's window excludes


def _stack(host: list[dict], key: str, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([h[key] for h in host]), device=device)


def _layout_errors(uv, valid, count, occ, hc, wc) -> torch.Tensor:
    """Per frame, the slots that break the emission's layout: the valid
    slots are the first `count`, on integer pixels, in strictly rising
    raster order of their cells, each owning its cell in the occupancy
    grid, which has no other owner; invalid slots are zero."""
    N, K = valid.shape
    slot = torch.arange(K, device=uv.device)
    bad = (valid != (slot[None, :] < count[:, None])).long()
    bad += (valid & (uv != uv.round()).any(-1)).long()
    bad += (~valid & (uv != 0).any(-1)).long()
    u = uv[..., 0].round().long().clamp(0, wc * 8 - 1)
    v = uv[..., 1].round().long().clamp(0, hc * 8 - 1)
    cell = (v // 8) * wc + u // 8
    rising = torch.ones_like(valid)
    rising[:, 1:] = cell[:, 1:] > cell[:, :-1]
    bad += (valid & ~rising).long()
    flat = occ.reshape(N, -1)
    owner = torch.gather(flat, 1, cell)
    bad += (valid & (owner != slot[None, :])).long()
    errors = bad.sum(1)
    return errors + ((flat >= 0).sum(1) - count).abs()


class Readings:
    """Running maxima, counts and gaps over the judged frames."""

    def __init__(self):
        self.gaps = dict(dust_gap=0.0, score_gap=0.0, kp_pixel_gap=0.0,
                         resp_gap=0.0, desc_gap=0.0, match_gap=0.0,
                         cov_gap_max=0.0)
        self.cov: list = []   # relative covariance gaps of the keypoints
        self.match = [0, 0]   # rows otherwise, rows judged
        self.kp = [0, 0]      # cells in one set only, reference keypoints
        self.frames = 0

    def gap(self, name: str, x: torch.Tensor) -> None:
        if x.numel():
            v = float(x.max())
            self.gaps[name] = max(self.gaps[name],
                                  v if math.isfinite(v) else math.inf)

    def result(self) -> dict:
        out = dict(self.gaps)
        gaps = (torch.cat(self.cov).double().cpu().numpy() if self.cov
                else np.zeros(1))
        out["cov_gap_p90"] = float(np.percentile(gaps, 90))
        out["cov_gap_max"] = max(out["cov_gap_max"], float(gaps.max()))
        out["match_diff"] = self.match[0] / max(self.match[1], 1)
        out["kp_set_diff"] = self.kp[0] / max(self.kp[1], 1)
        out["frames_judged"] = self.frames
        return out


def judge_block(r: Readings, images, host, outs, match12, prev, weights,
                cfg) -> None:
    """Judge one block of frames: host mirrors `host` (a dict per frame),
    the device outputs `outs` (desc, semi_dust), the match indices and the
    previous frames' features `prev` (desc, uv, valid)."""
    dev = images.device
    ref = reference.maps(images, weights, cfg)
    N, hc, wc = ref.semi_dust.shape
    uv = _stack(host, "uv", dev).float()
    valid = _stack(host, "valid", dev).bool()
    count = torch.as_tensor([int(h["count"]) for h in host], device=dev)
    occ = _stack(host, "occ_grid", dev).long()
    r.frames += N

    r.gap("dust_gap", (outs["semi_dust"].float() - ref.semi_dust).abs())
    u = uv[..., 0].round().long().clamp(0, wc * 8 - 1)
    v = uv[..., 1].round().long().clamp(0, hc * 8 - 1)
    cell = (v // 8) * wc + u // 8
    score_ref = torch.gather(ref.score.reshape(N, -1), 1, cell)
    score = _stack(host, "score", dev).float()
    r.gap("score_gap", ((score - score_ref).abs())[valid])
    logits = ref.logits[:, :64].reshape(N, 64, -1)
    at_cell = torch.gather(logits, 2, cell[:, None, :].expand(N, 64, -1))
    chan = (v % 8) * 8 + u % 8
    own = torch.gather(at_cell, 1, chan[:, None, :])[:, 0]
    r.gap("kp_pixel_gap", (at_cell.amax(1) - own)[valid])

    # the reference's own keypoints, against the step's
    alive = reference.nms.grid_nms(ref.score, ref.cand_uv, ref.cand_valid,
                                   dist=cfg["nms_dist"],
                                   iters=cfg["nms_iters"])
    kp = reference.nms.select(ref.score, ref.cand_uv, alive,
                              num_features=cfg["num_features"],
                              max_keypoints=cfg["max_keypoints"],
                              border=cfg["border"])
    n_cells = hc * wc
    mine = torch.zeros((N, n_cells + 1), dtype=torch.bool, device=dev)
    mine.scatter_(1, torch.where(valid, cell, n_cells), True)
    theirs = (kp.occ_grid.reshape(N, -1) >= 0)
    diff = (mine[:, :n_cells] != theirs).sum(1)
    errors = _layout_errors(uv, valid, count, occ, hc, wc)
    r.kp[0] += int((diff + errors).sum())
    r.kp[1] += int(theirs.sum())

    resp = _stack(host, "response", dev).float()
    heat_at = ref.heat_inv.reshape(N, -1).gather(1, v * wc * 8 + u)
    r.gap("resp_gap", (resp - torch.where(valid, heat_at, 0.0)).abs())
    cov2_ref, _ = covariance.covariance(
        ref.heat_inv, uv, valid, radius=cfg["cov_window"],
        iters=cfg["cov_iters"])
    cov2 = 1.0 / _stack(host, "cov2_inv", dev).float()
    rel = (cov2 / cov2_ref - 1.0).abs().amax(-1)
    r.cov.append(rel[valid])
    r.gap("cov_gap_max", rel[~valid])

    desc_ref = descriptors.sample(ref.unit_desc, uv, valid)
    r.gap("desc_gap", torch.linalg.vector_norm(
        outs["desc"].float() - desc_ref, dim=-1))

    # the matcher on the step's own features
    m12 = torch.as_tensor(match12, device=dev).long()
    m = cfg["match"]
    dec = matching.decide(prev["desc"], prev["valid"], prev["uv"],
                          outs["desc"].float(), uv, valid,
                          window=m["window"], ratio=m["ratio"],
                          th=m["th_low"])
    rows = prev["valid"]
    r.match[0] += int(((m12 != dec.match12) & rows).sum()
                      + ((m12 >= 0) & ~rows).sum())
    r.match[1] += int(rows.sum())
    r.gap("match_gap", matching.margins(dec, m12, ratio=m["ratio"],
                                        th=m["th_low"],
                                        out_of_window=OUT_OF_MASK))


def readings(sample: list[dict], state: dict, cfg: dict, device,
             block: int = 8) -> dict:
    """Every number of the comparison over the sampled steps.  A step of
    `sample` holds `images` (B, H, W) float32, `host` (the B host mirrors),
    `match12` (B, K), `outs` and `prev` (device tensors)."""
    weights = reference.weights_on(state, device)
    r = Readings()
    with torch.inference_mode():
        for step in sample:
            B = len(step["host"])
            for lo in range(0, B, block):
                sl = slice(lo, min(B, lo + block))
                judge_block(
                    r, torch.as_tensor(step["images"][sl], device=device),
                    step["host"][sl],
                    {k: t[sl] for k, t in step["outs"].items()},
                    step["match12"][sl],
                    {k: t[sl] for k, t in step["prev"].items()}, weights,
                    cfg)
    return r.result()


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers `limits`
    names; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        if not math.isfinite(v):
            v = math.inf
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks
