"""Descriptor sampling at the keypoints of one batch, from the raw map.

Bytes: each distinct raw descriptor row that a valid slot's four bilinear
corners touch, read once in the map's type (2 bytes an element in
bfloat16, 4 in float32); each slot's uv and valid flag read once; the
(B, K, 256) float32 output written once (invalid slots are zeros, written
too).  Operations: a valid slot normalises its four corner rows and
renormalises their weighted sum, 256 x (4 x 4 + 3).
"""

import numpy as np

D = 256


def corner_rows(uv: np.ndarray, valid: np.ndarray, H: int, W: int) -> int:
    hc, wc = H // 8, W // 8
    total = 0
    for b in range(uv.shape[0]):
        p = uv[b][valid[b]]
        gx = np.clip(np.floor(p[:, 0] * (wc - 1) / W), 0, wc - 2).astype(
            np.int64)
        gy = np.clip(np.floor(p[:, 1] * (hc - 1) / H), 0, hc - 2).astype(
            np.int64)
        r0 = gy * wc + gx
        total += np.unique(np.concatenate([r0, r0 + 1, r0 + wc,
                                           r0 + wc + 1])).size
    return total


def count(x: dict, config: dict) -> dict:
    B, K = x["B"], x["K"]
    rows = corner_rows(x["uv"], x["valid"], x["H"], x["W"])
    n_valid = int(x["valid"].sum())
    return dict(flops=float(n_valid * D * (4 * 4 + 3)),
                bytes=rows * D * x["raw_desc_bytes"] + B * K * (8 + 1)
                + B * K * D * 4,
                peak="fp32")
