"""Bilinear descriptor sampling, plain PyTorch.

The reference's grid_sampler_2d(align_corners=True) with grid = uv / (size
/ 2) - 1 (sp_extractor.cpp:134-148): the sample lies at x = u (wc - 1) / W,
y = v (hc - 1) / H in the cell map of unit descriptor rows; the four
corners' weighted sum is renormalised to unit length.
"""

from __future__ import annotations

import torch


def sample(unit_desc: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor
           ) -> torch.Tensor:
    """unit_desc (N, hc, wc, D), uv (N, K, 2) pixels, valid (N, K) ->
    (N, K, D) unit descriptors, zero on invalid slots."""
    N, hc, wc, D = unit_desc.shape
    H, W = hc * 8, wc * 8
    K = uv.shape[1]
    gx = uv[..., 0] * (wc - 1) / W
    gy = uv[..., 1] * (hc - 1) / H
    x0 = gx.floor().long().clamp(0, wc - 1)
    y0 = gy.floor().long().clamp(0, hc - 1)
    x1 = (x0 + 1).clamp(max=wc - 1)
    y1 = (y0 + 1).clamp(max=hc - 1)
    du = (gx - x0)[..., None]
    dv = (gy - y0)[..., None]
    flat = unit_desc.reshape(N, hc * wc, D)

    def corner(yy, xx):
        return torch.gather(flat, 1, (yy * wc + xx)[..., None].expand(
            N, K, D))

    d = ((1 - du) * (1 - dv) * corner(y0, x0) + du * (1 - dv) * corner(y0, x1)
         + (1 - du) * dv * corner(y1, x0) + du * dv * corner(y1, x1))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.where(valid[..., None], d, 0.0)
