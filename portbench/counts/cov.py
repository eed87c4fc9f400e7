"""The covariance fill of one batch: bytes only.

The inverted heat map is needed where some valid keypoint's window (2r+1
pixels a side, clipped into the image as the fill clips it) reaches: the
union of those windows, 4 bytes a pixel, read once.  Each slot's uv and
valid flag are read once and its cov2, cov2_inv (2 float32 each) and
response (float32) written once.  The fill's comparisons and the weighted
moments of the reached pixels depend on the data and are not counted.
"""

import numpy as np


def window_union(uv: np.ndarray, valid: np.ndarray, H: int, W: int,
                 radius: int) -> int:
    """Pixels of the union of the valid keypoints' clipped windows, summed
    over the batch (a 2-D difference array a frame)."""
    size = 2 * radius + 1
    total = 0
    for b in range(uv.shape[0]):
        p = uv[b][valid[b]].astype(np.int64)
        u0 = np.clip(p[:, 0] - radius, 0, W - size)
        v0 = np.clip(p[:, 1] - radius, 0, H - size)
        diff = np.zeros((H + 1, W + 1), np.int32)
        np.add.at(diff, (v0, u0), 1)
        np.add.at(diff, (v0, u0 + size), -1)
        np.add.at(diff, (v0 + size, u0), -1)
        np.add.at(diff, (v0 + size, u0 + size), 1)
        cover = diff.cumsum(0).cumsum(1)[:H, :W]
        total += int((cover > 0).sum())
    return total


def count(x: dict, config: dict) -> dict:
    B, K = x["B"], x["K"]
    pixels = window_union(x["uv"], x["valid"], x["H"], x["W"],
                          config["cov_window"])
    return dict(flops=0.0, bytes=pixels * 4 + B * K * (8 + 1 + 20),
                peak="fp32")
