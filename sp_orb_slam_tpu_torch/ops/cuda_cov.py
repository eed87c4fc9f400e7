"""The covariance flood fill as one Hopper kernel per batch (csrc/cov.cu).

The port's counterpart of the TPU kernel sp_orb_slam_tpu/ops/pallas_cov.py
`pallas_covariance`.  The wrapper launches the kernel for a CUDA tensor and
runs the plain PyTorch fill (ops/covariance.py `keypoint_covariance`) for a
CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.ops.covariance import keypoint_covariance

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
MAX_RADIUS = 15  # csrc/cov.cu builds one kernel instance per radius 0-15


def batched_covariance(heat_inv: torch.Tensor, uv: torch.Tensor,
                       valid: torch.Tensor, *, radius: int = 8,
                       iters: int = 16):
    """heat_inv (B, H, W) f32, uv (B, K, 2) f32, valid (B, K) bool ->
    (cov2 (B, K, 2), cov2_inv (B, K, 2), response (B, K))."""
    if heat_inv.device.type == "cpu":
        return keypoint_covariance(heat_inv, uv, valid, radius=radius,
                                   iters=iters)
    B, H, W = heat_inv.shape
    K = uv.shape[1]
    size = 2 * radius + 1
    if not 0 <= radius <= MAX_RADIUS or size > min(H, W):
        raise ValueError(f"cov kernel: instances for radius 0-{MAX_RADIUS} "
                         f"and a window inside the image, got radius "
                         f"{radius}, {H}x{W}")
    _build.check(heat_inv, "heat_inv", torch.float32, (B, H, W))
    _build.check(uv, "uv", torch.float32, (B, K, 2))
    _build.check(valid, "valid", torch.bool, (B, K))
    if uv.data_ptr() % 8:
        # the kernel reads each keypoint's uv as one float2
        raise ValueError("cov kernel needs 8-byte aligned uv")
    dev = heat_inv.device
    cov2 = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    cov2_inv = torch.empty_like(cov2)
    resp = torch.empty((B, K), dtype=torch.float32, device=dev)
    _build.launch("cov", "cov_launch", _ARGS, heat_inv.data_ptr(),
                  uv.data_ptr(), valid.data_ptr(), cov2.data_ptr(),
                  cov2_inv.data_ptr(), resp.data_ptr(), B, K, H, W, radius,
                  iters, device=dev)
    return cov2, cov2_inv, resp
