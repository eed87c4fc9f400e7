"""The grid NMS fixed point over one batch: bytes only.

Its inputs (per cell: float32 score, int32 (u, v), bool valid) are read
once and its bool survivor mask written once; the rounds re-read what sits
on chip and add no bytes, and its comparisons are not counted.
"""


def count(x: dict, config: dict) -> dict:
    cells = x["B"] * (x["H"] // 8) * (x["W"] // 8)
    return dict(flops=0.0, bytes=cells * (4 + 8 + 1 + 1), peak="fp32")
