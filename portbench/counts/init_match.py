"""The windowed init matcher over one batch.

Operations: a dot product of 256 (2 x 256) for each pair of a valid old
keypoint and a valid new one inside the window (|du|, |dv| < window px),
the pairs these inputs need; the distance, ratio and claim arithmetic is
not counted.  Bytes: each valid slot's descriptor (256 float32) read once,
every slot's uv and valid flag read once, match12 (int32 a row), match21
(int32 a column) and the count (int32 a frame) written once.  Peak: the
float32 rate (the dot products run outside the tensor cores).
"""

import numpy as np

D = 256


def pairs_in_window(uv1, valid1, uv2, valid2, window: float, H: int,
                    W: int) -> int:
    """Pairs (valid old, valid new) with |du| < window and |dv| < window,
    summed over the batch; keypoints sit on integer pixels, so each old
    keypoint's count is a rectangle sum of an integral image of the new
    ones."""
    reach = int(np.ceil(window)) - 1
    total = 0
    for b in range(uv1.shape[0]):
        p = uv1[b][valid1[b]]
        q = uv2[b][valid2[b]]
        if not (np.all(p == np.round(p)) and np.all(q == np.round(q))):
            raise ValueError("keypoints off integer pixels")
        grid = np.zeros((H + 1, W + 1), np.int64)
        np.add.at(grid, (q[:, 1].astype(np.int64) + 1,
                         q[:, 0].astype(np.int64) + 1), 1)
        grid = grid.cumsum(0).cumsum(1)
        u, v = p[:, 0].astype(np.int64), p[:, 1].astype(np.int64)
        u0, u1 = np.clip(u - reach, 0, W), np.clip(u + reach + 1, 0, W)
        v0, v1 = np.clip(v - reach, 0, H), np.clip(v + reach + 1, 0, H)
        total += int((grid[v1, u1] - grid[v0, u1] - grid[v1, u0]
                      + grid[v0, u0]).sum())
    return total


def count(x: dict, config: dict) -> dict:
    B, K = x["B"], x["K"]
    pairs = pairs_in_window(x["prev_uv"], x["prev_valid"], x["uv"],
                            x["valid"], config["match"]["window"], x["H"],
                            x["W"])
    n_desc = int(x["prev_valid"].sum() + x["valid"].sum())
    return dict(flops=2.0 * D * pairs,
                bytes=n_desc * D * 4 + 2 * B * K * (8 + 1) + B * K * 4 * 2
                + B * 4,
                peak="fp32")
