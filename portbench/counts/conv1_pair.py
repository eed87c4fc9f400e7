"""The first conv pair (conv1a, conv1b, ReLU, 2x2 max pool), fused: its
operations and the bytes its inputs and output need.

Operations: 2 B H W 64 (9 + 64 x 9), both convolutions at full resolution.
Bytes: the float32 images read once, the float32 weights and biases read
once, the bfloat16 (B, H/2, W/2, 64) output written once.  Peak: the
bfloat16 tensor-core rate.
"""


def count(x: dict, config: dict) -> dict:
    B, H, W = x["B"], x["H"], x["W"]
    weights = (64 * 9 + 64 + 64 * 64 * 9 + 64) * 4
    return dict(flops=2.0 * B * H * W * 64 * (9 + 64 * 9),
                bytes=B * H * W * 4 + weights + B * (H // 2) * (W // 2) * 64 * 2,
                peak="bf16_dense")
