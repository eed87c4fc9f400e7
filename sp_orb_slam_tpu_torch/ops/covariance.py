"""Per-keypoint repeatability covariance from the heat map, batched.

Reference (src/cv/sp_extractor.cpp:252-340 computeCovariance), as in the JAX
package's ops/covariance.py: for each keypoint, a flood fill on the inverted
heat map `heat_inv` expands to 4-neighbours whose value is positive and
strictly below the value of the pixel it is reached from (monotone
descent); the visited pixels' values weight their squared offsets:

    cov = sum_p (w_p / sum w) * (p - kp)^2   (per axis, diagonal 2-vector)

clamped to >= 1, with `cov2_inv = 1 / cov2`; the response is the heat value
at the keypoint.  The fill is bounded to a (2r+1)^2 window and `iters`
rounds of mask growth (`keypoint_covariance`; the kernel in ops/cuda_cov.py
runs the same rounds); `covariance_reference` is the sequential BFS golden.
`dense_covariance` is the JAX package's dense-ownership formulation
(`cov_method="dense"`): one basin-label image over the whole map instead
of a window per keypoint.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _window_gather(heat: torch.Tensor, uv: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """(B, K, s, s) windows of heat (B, H, W) at integer uv (B, K, 2),
    clipped to stay inside the image."""
    size = 2 * radius + 1
    B, H, W = heat.shape
    u0 = (uv[..., 0].to(torch.int32) - radius).clamp(0, W - size).long()
    v0 = (uv[..., 1].to(torch.int32) - radius).clamp(0, H - size).long()
    ar = torch.arange(size, device=heat.device)
    rows = v0[..., None, None] + ar[:, None]           # (B, K, s, 1)
    cols = u0[..., None, None] + ar[None, :]           # (B, K, 1, s)
    flat = (rows * W + cols).reshape(B, -1)
    return torch.gather(heat.reshape(B, -1), 1, flat).reshape(
        B, -1, size, size)


def keypoint_covariance(heat_inv: torch.Tensor, uv: torch.Tensor,
                        valid: torch.Tensor, *, radius: int = 8,
                        iters: int = 16):
    """(cov2 (B, K, 2), cov2_inv (B, K, 2), response (B, K)) for heat_inv
    (B, H, W), uv (B, K, 2) float (integer-valued), valid (B, K) bool."""
    size = 2 * radius + 1
    win = _window_gather(heat_inv, uv, radius)         # (B, K, s, s)
    response = win[..., radius, radius]
    pos = win > 0.0
    win_pad = F.pad(win, (1, 1, 1, 1), value=float("-inf"))
    n_vals = [win_pad[..., 1 + dv:1 + dv + size, 1 + du:1 + du + size]
              for dv, du in _DIRS]
    reach = torch.zeros_like(pos)
    reach[..., radius, radius] = True
    for _ in range(iters):
        reach_pad = F.pad(reach, (1, 1, 1, 1))
        grow = torch.zeros_like(reach)
        for nv, (dv, du) in zip(n_vals, _DIRS):
            nr = reach_pad[..., 1 + dv:1 + dv + size, 1 + du:1 + du + size]
            grow |= nr & (win < nv)
        reach = reach | (grow & pos)

    d = torch.arange(size, dtype=torch.float32, device=win.device) - radius
    w = torch.where(reach, win, 0.0)
    wsum = w.sum((-2, -1)).clamp_min(1e-12)
    cov_x = (w * d[None, :] * d[None, :]).sum((-2, -1)) / wsum
    cov_y = (w * d[:, None] * d[:, None]).sum((-2, -1)) / wsum
    cov2 = torch.stack([cov_x.clamp_min(1.0), cov_y.clamp_min(1.0)], -1)
    cov2 = torch.where(valid[..., None], cov2, 1.0)
    return cov2, 1.0 / cov2, torch.where(valid, response, 0.0)


def dense_covariance(heat_inv: torch.Tensor, occ_grid: torch.Tensor,
                     uv: torch.Tensor, valid: torch.Tensor, *, cell: int = 8,
                     iters: int = 16):
    """The dense-ownership covariance fill of a batch: a basin-ownership
    label image propagated over the full map (each round takes the four
    directions in turn), then each keypoint's weighted moments from 5x5-cell
    masked block sums.  As in the JAX package, a pixel on the boundary of
    two basins counts for one keypoint (the first to reach it) instead of
    both, and a pixel whose owner lies more than 2 cells away is dropped.

    heat_inv (B, H, W); occ_grid (B, hc, wc) int; uv (B, K, 2); valid (B, K)
    -> (cov2 (B, K, 2), cov2_inv (B, K, 2), response (B, K))."""
    B, H, W = heat_inv.shape
    hc, wc = occ_grid.shape[-2:]
    dev = heat_inv.device
    u_kp = uv[..., 0].to(torch.int32).clamp(0, W - 1).long()
    v_kp = uv[..., 1].to(torch.int32).clamp(0, H - 1).long()
    bidx = torch.arange(B, device=dev)[:, None].expand_as(u_kp)
    response = torch.where(valid, heat_inv[bidx, v_kp, u_kp], 0.0)

    # seed the label image at the keypoint pixels with the flat cell index
    # (invalid keypoints write to a spare column, dropped)
    cell_of_kp = (v_kp // cell) * wc + u_kp // cell
    label = torch.full((B, H * W + 1), -1, dtype=torch.long, device=dev)
    label = label.scatter(1, torch.where(valid, v_kp * W + u_kp, H * W),
                          torch.where(valid, cell_of_kp, -1))
    label = label[:, :H * W].reshape(B, H, W)
    pos = heat_inv > 0.0

    def nview(x_pad, dv, du):
        return x_pad[:, 1 + dv:1 + dv + H, 1 + du:1 + du + W]

    heat_pad = F.pad(heat_inv, (1, 1, 1, 1), value=float("-inf"))
    n_heat = {d: nview(heat_pad, *d) for d in _DIRS}
    for _ in range(iters):
        for d in _DIRS:
            nL = nview(F.pad(label, (1, 1, 1, 1), value=-1), *d)
            take = (label < 0) & (nL >= 0) & (heat_inv < n_heat[d]) & pos
            label = torch.where(take, nL, label)

    # each pixel's owner-offset code in [0, 25): the owner cell at (dcv,
    # dcu) = owner - own cell, within +-2 cells; 25 = no owner in range
    r = 2
    side = 2 * r + 1
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    own_cell = (rows // cell) * wc + cols // cell
    owned = label >= 0
    dcell = torch.where(owned, label - own_cell, 10 ** 6)
    dcv = torch.where(owned, torch.div(dcell + wc // 2, wc,
                                       rounding_mode="floor"), 10 ** 6)
    dcu = dcell - dcv * wc
    in_range = owned & (dcv.abs() <= r) & (dcu.abs() <= r)
    code = torch.where(in_range, (dcv + r) * side + (dcu + r), side * side)

    # weighted moments in cell-local coordinates (absolute-pixel moments
    # cancel in float32): [w, w lu, w lu^2, w lv, w lv^2]
    uu = (cols % cell).to(heat_inv.dtype)
    vv = (rows % cell).to(heat_inv.dtype)
    w = heat_inv
    quant = torch.stack([w, w * uu, w * uu * uu, w * vv, w * vv * vv], 1)
    # per cell, the 5 moments split by offset code: each cell's 64 pixels
    # (raster order) summed in four interleaved partial sums combined
    # pairwise, the order of the JAX package's one-hot contraction on the
    # CPU, so the moments agree with it to the bit
    n_codes = side * side + 1
    onehot = F.one_hot(code, n_codes).to(heat_inv.dtype)   # (B, H, W, 26)
    q_pix = quant.reshape(B, 5, hc, cell, wc, cell).transpose(3, 4)
    o_pix = onehot.reshape(B, hc, cell, wc, cell, n_codes).transpose(2, 3)
    terms = (q_pix.reshape(B, 5, hc, wc, cell * cell // 4, 4, 1)
             * o_pix.reshape(B, 1, hc, wc, cell * cell // 4, 4, n_codes))
    lanes = terms[..., 0, :, :]
    for j in range(1, terms.shape[-3]):
        lanes = lanes + terms[..., j, :, :]
    contrib = ((lanes[..., 0, :] + lanes[..., 1, :])
               + (lanes[..., 2, :] + lanes[..., 3, :]))    # (B, 5, hc, wc, 26)

    acc = torch.zeros((B, 5, hc, wc), dtype=heat_inv.dtype, device=dev)
    for dv_ in range(-r, r + 1):
        for du_ in range(-r, r + 1):
            o = (dv_ + r) * side + (du_ + r)
            # code-o pixels of cell c belong to the keypoint of cell c +
            # (dv_, du_): move the slab there, coordinates to its origin
            m = torch.roll(contrib[..., o], shifts=(dv_, du_), dims=(2, 3))
            ou, ov = float(-du_ * cell), float(-dv_ * cell)
            acc = acc + torch.stack([
                m[:, 0],
                m[:, 1] + ou * m[:, 0],
                m[:, 2] + 2.0 * ou * m[:, 1] + ou * ou * m[:, 0],
                m[:, 3] + ov * m[:, 0],
                m[:, 4] + 2.0 * ov * m[:, 3] + ov * ov * m[:, 0]], 1)

    # each keypoint's sums through its own cell (cell-relative coordinates)
    cy = cell_of_kp // wc
    cx = cell_of_kp % wc
    at = acc.permute(0, 2, 3, 1)[bidx, cy, cx]              # (B, K, 5)
    s_w = at[..., 0].clamp_min(1e-12)
    uf = uv[..., 0] - (cx * cell).to(uv.dtype)
    vf = uv[..., 1] - (cy * cell).to(uv.dtype)
    cov_x = at[..., 2] / s_w - 2.0 * uf * at[..., 1] / s_w + uf * uf
    cov_y = at[..., 4] / s_w - 2.0 * vf * at[..., 3] / s_w + vf * vf
    cov2 = torch.stack([cov_x.clamp_min(1.0), cov_y.clamp_min(1.0)], -1)
    cov2 = torch.where(valid[..., None], cov2, 1.0)
    return cov2, 1.0 / cov2, response


def covariance_reference(heat_inv, uv, valid, radius=None):
    """Sequential numpy golden model of the reference BFS (single-count
    variant) for one image.  With `radius` set, the fill is restricted to the
    same bounded window as `keypoint_covariance`; without, it reproduces the
    reference's unbounded BFS."""
    heat_inv = np.asarray(heat_inv)
    H, W = heat_inv.shape
    K = uv.shape[0]
    cov2 = np.ones((K, 2), np.float32)
    resp = np.zeros((K,), np.float32)
    for k in range(K):
        if not valid[k]:
            continue
        u0, v0 = int(uv[k, 0]), int(uv[k, 1])
        resp[k] = heat_inv[v0, u0]
        seen = {(u0, v0)}
        q = deque([(u0, v0)])
        deltas, scores = [], []
        while q:
            u, v = q.popleft()
            val = heat_inv[v, u]
            deltas.append(((u - u0) ** 2, (v - v0) ** 2))
            scores.append(val)
            for du, dv in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                uu, vv = u + du, v + dv
                if not (0 <= uu < W and 0 <= vv < H):
                    continue
                if radius is not None and (abs(uu - u0) > radius
                                           or abs(vv - v0) > radius):
                    continue
                hv = heat_inv[vv, uu]
                if (uu, vv) not in seen and hv > 0.0 and hv < val:
                    seen.add((uu, vv))
                    q.append((uu, vv))
        s = np.asarray(scores, np.float32)
        d = np.asarray(deltas, np.float32)
        w = s / max(s.sum(), 1e-12)
        c = (w[:, None] * d).sum(0)
        cov2[k] = np.maximum(c, 1.0)
    return cov2, 1.0 / cov2, resp
