"""Each keypoint's repeatability covariance, plain PyTorch.

The reference's computeCovariance (sp_extractor.cpp:252-340): from the
keypoint, a fill over the inverted heat map spreads to 4-neighbours whose
value is positive and strictly below the value of the pixel it is reached
from; the visited pixels' values weight their squared offsets,
cov = sum w (p - kp)^2 / sum w per axis, clamped to >= 1.  The fill is
bounded to a (2r + 1)^2 window (clipped into the image) and `iters` rounds
of growth, as the extractor configures it.  The response is the inverted
heat at the keypoint.  A frozen copy of the port's plain windowed fill.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _windows(heat, uv, radius):
    size = 2 * radius + 1
    N, H, W = heat.shape
    u0 = (uv[..., 0].long() - radius).clamp(0, W - size)
    v0 = (uv[..., 1].long() - radius).clamp(0, H - size)
    ar = torch.arange(size, device=heat.device)
    rows = v0[..., None, None] + ar[:, None]
    cols = u0[..., None, None] + ar[None, :]
    flat = (rows * W + cols).reshape(N, -1)
    return torch.gather(heat.reshape(N, -1), 1, flat).reshape(
        N, -1, size, size)


def covariance(heat_inv, uv, valid, *, radius: int, iters: int):
    """heat_inv (N, H, W), uv (N, K, 2) integer-valued, valid (N, K) ->
    (cov2 (N, K, 2), response (N, K)); invalid slots 1 and 0."""
    size = 2 * radius + 1
    win = _windows(heat_inv, uv, radius)
    response = win[..., radius, radius]
    pos = win > 0.0
    pad = F.pad(win, (1, 1, 1, 1), value=float("-inf"))
    nbr = [pad[..., 1 + dv:1 + dv + size, 1 + du:1 + du + size]
           for dv, du in _DIRS]
    reach = torch.zeros_like(pos)
    reach[..., radius, radius] = True
    for _ in range(iters):
        rpad = F.pad(reach, (1, 1, 1, 1))
        grow = torch.zeros_like(reach)
        for nv, (dv, du) in zip(nbr, _DIRS):
            grow |= rpad[..., 1 + dv:1 + dv + size,
                         1 + du:1 + du + size] & (win < nv)
        reach = reach | (grow & pos)
    d = torch.arange(size, dtype=torch.float32, device=win.device) - radius
    w = torch.where(reach, win, 0.0)
    wsum = w.sum((-2, -1)).clamp_min(1e-12)
    cx = (w * (d * d)[None, :]).sum((-2, -1)) / wsum
    cy = (w * (d * d)[:, None]).sum((-2, -1)) / wsum
    cov2 = torch.stack([cx.clamp_min(1.0), cy.clamp_min(1.0)], -1)
    cov2 = torch.where(valid[..., None], cov2, 1.0)
    return cov2, torch.where(valid, response, 0.0)
