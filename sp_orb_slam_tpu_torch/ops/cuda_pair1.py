"""The SuperPoint first conv pair in the row-pair formulation, one Hopper
kernel (csrc/pair1.cu).

maxpool2(relu(conv1b(relu(conv1a(x))))) on the bfloat16 path, (B, H, W)
float32 images -> (B, H/2, W/2, 64) bfloat16 NHWC; the port's counterpart of
the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1.py `fused_pair1`, selected by
`conv_packing="pair1"`.  It computes the same function as ops/cuda_pair1t.py
with another design (conv1a as an im2col product, conv1b as the row-pair
block matrix), so its plain version is that module's: the stock bf16 pair.
The wrapper launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.ops.cuda_pair1t import fused_pair1t_plain

C = 64
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3

fused_pair1_plain = fused_pair1t_plain


def fused_pair1(images: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
                w1b: torch.Tensor, b1b: torch.Tensor) -> torch.Tensor:
    """images (B, H, W) float32 in [0, 1] -> pooled (B, H/2, W/2, 64) bf16.
    Weights are OIHW (64, 1, 3, 3) / (64, 64, 3, 3), biases (64,).

    Requires H % 8 == 0 and W % 2 == 0 (EuRoC 752x480, Tsukuba 640x480)."""
    B, H, W = images.shape
    if H % 8 or W % 2:
        raise ValueError(f"pair1 needs H % 8 == 0 and W % 2 == 0, got "
                         f"{H}x{W}")
    if images.device.type == "cpu":
        return fused_pair1_plain(images, w1a, b1a, w1b, b1b)
    _build.check(images, "images", torch.float32, (B, H, W))
    dev = images.device
    # conv1a as the (16, 64) tap matrix: row dy*3+dx, rows 9..15 zero
    wa = torch.zeros((16, C), dtype=torch.bfloat16, device=dev)
    wa[:9] = w1a.to(dev, torch.bfloat16).reshape(C, 9).t()
    wb = (w1b.to(dev, torch.bfloat16).permute(2, 3, 1, 0)
          .reshape(9 * C, C).contiguous())           # [dy*3+dx][ci][co]
    ba = b1a.to(dev, torch.float32).contiguous()
    bb = b1b.to(dev, torch.float32).contiguous()
    _build.check(wa, "w1a16", torch.bfloat16, (16, C))
    _build.check(wb, "w1b", torch.bfloat16, (9 * C, C))
    _build.check(ba, "b1a", torch.float32, (C,))
    _build.check(bb, "b1b", torch.float32, (C,))
    out = torch.empty((B, H // 2, W // 2, C), dtype=torch.bfloat16,
                      device=dev)
    _build.launch("pair1", "pair1_launch", _ARGS, images.data_ptr(),
                  wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                  out.data_ptr(), B, H, W, device=dev)
    return out


def blocks_per_sm(device: torch.device) -> int:
    """How many blocks of the kernel an SM holds at once (the CUDA
    occupancy calculator at the kernel's shared-memory size)."""
    n = ctypes.c_int(0)
    fn = _build.function("pair1", "pair1_occupancy", [ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(n), None)
    if err != 0:
        raise RuntimeError(f"pair1 occupancy query: CUDA error {err}")
    return n.value
