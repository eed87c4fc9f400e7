"""The SuperPoint first conv pair as one Hopper kernel (csrc/pair1t.cu).

maxpool2(relu(conv1b(relu(conv1a(x))))) on the bfloat16 path, (B, H, W)
float32 images -> (B, H/2, W/2, 64) bfloat16 NHWC; the port's counterpart of
the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1t.py `fused_pair1t`.  The
kernel runs conv1b as the transposed GEMM of that design, output channels
x pixels, on `wgmma` with both operands in shared memory; it is what
conv_packing="pair1t" runs.  The wrapper launches the kernel for a CUDA
tensor and runs `fused_pair1t_plain`, the same arithmetic in plain
PyTorch, for a CPU tensor.

The kernel takes the weights as the pair1 kernel does, from the same cache
(ops/cuda_pair1.py `packed_weights`) or from the caller (`packed`): conv1b
as [tap][co][ci] bf16 with the 128-byte swizzle applied, conv1a as [co][16
taps].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.utils.precision import full_f32

C = 64
TILE_H, TILE_W = 2, 128  # full-resolution rows x columns of a kernel tile
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
_GRID_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
_ROW_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def fused_pair1t_plain(images: torch.Tensor, w1a: torch.Tensor,
                       b1a: torch.Tensor, w1b: torch.Tensor,
                       b1b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, rounding where the kernel rounds: bf16 input
    and weights, float32 sums, float32 bias + relu, bf16 y1, bf16 output.
    Weights are OIHW (64, 1, 3, 3) / (64, 64, 3, 3), biases (64,)."""
    bf = torch.bfloat16
    x = images.to(bf).float()[:, None]
    with full_f32():
        y1 = F.conv2d(x, w1a.to(bf).float(), padding=1)
        y1 = (y1 + b1a.float().view(1, C, 1, 1)).relu().to(bf).float()
        z = F.conv2d(y1, w1b.to(bf).float(), padding=1)
        z = (z + b1b.float().view(1, C, 1, 1)).relu()
    # rounding is monotone, so pooling before the bf16 cast == after it
    return F.max_pool2d(z, 2).to(bf).permute(0, 2, 3, 1).contiguous()


def fused_pair1t(images: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
                 w1b: torch.Tensor, b1b: torch.Tensor, *,
                 packed: tuple | None = None) -> torch.Tensor:
    """images (B, H, W) float32 in [0, 1] -> pooled (B, H/2, W/2, 64) bf16;
    `packed` as in ops/cuda_pair1.py `fused_pair1`.

    Requires H % 8 == 0 and W % 2 == 0, and W % 4 == 0 on the card
    (EuRoC 752x480, Tsukuba 640x480)."""
    B, H, W = images.shape
    if H % 8 or W % 2:
        raise ValueError(f"pair1t needs H % 8 == 0 and W % 2 == 0, got "
                         f"{H}x{W}")
    if images.device.type == "cpu":
        return fused_pair1t_plain(images, w1a, b1a, w1b, b1b)
    if W % 4:
        raise ValueError(f"the pair1t kernel loads rows by TMA, 16-byte "
                         f"strides: it needs W % 4 == 0, got W={W}")
    _build.check(images, "images", torch.float32, (B, H, W))
    dev = images.device
    # cuda_pair1 imports this module for the plain version: import it here
    from sp_orb_slam_tpu_torch.ops import cuda_pair1

    wa, ba, wb, bb = (packed if packed is not None else
                      cuda_pair1.packed_weights(w1a, b1a, w1b, b1b, dev))
    _build.check(wa, "w1a", torch.bfloat16, (C, 16))
    _build.check(wb, "w1b", torch.bfloat16, (9, C, C))
    _build.check(ba, "b1a", torch.float32, (C,))
    _build.check(bb, "b1b", torch.float32, (C,))
    out = torch.empty((B, H // 2, W // 2, C), dtype=torch.bfloat16,
                      device=dev)
    _build.launch("pair1t", "pair1t_launch", _ARGS, images.data_ptr(),
                  wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                  out.data_ptr(), B, H, W, device=dev)
    return out


def tiles(B: int, H: int, W: int) -> int:
    """Tiles of the kernel for (B, H, W) images: 2 rows x 128 columns each,
    the right band ragged."""
    return B * (H // TILE_H) * -(-W // TILE_W)


def launch_grid(B: int, H: int, W: int,
                device: torch.device) -> tuple[int, int, int]:
    """(grid, resident blocks an SM, SMs) of the persistent launch for
    (B, H, W): the CUDA occupancy calculator at the kernel's shared-memory
    size, and grid = min(tiles, SMs x blocks)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.function("pair1t", "pair1t_grid", _GRID_ARGS)
    with torch.cuda.device(device):
        err = fn(B, H, W, *(ctypes.addressof(v) for v in vals), None)
    if err != 0:
        raise RuntimeError(f"pair1t grid query: CUDA error {err}")
    return tuple(v.value for v in vals)


def row_product(w: torch.Tensor, y: torch.Tensor,
                shift: int) -> torch.Tensor:
    """One k pass of the kernel's conv1b alone, on the card: (64, 128) f32
    = w (64 co x 64 ci, one tap of `cuda_pair1.pack_w1b`, swizzled) times
    pixels shift .. shift + 127 of y (n_pix x 64 ci bf16), with y stored
    and read as the kernel stores and reads y1 (a tap's column shift is a
    start offset inside the 128-byte swizzle atom)."""
    n_pix = y.shape[0]
    if not 0 <= shift <= n_pix - 2 * C or n_pix > 512:
        raise ValueError(f"row_product: shift {shift} of {n_pix} pixels")
    _build.check(w, "w", torch.bfloat16, (C, C))
    _build.check(y, "y", torch.bfloat16, (n_pix, C))
    out = torch.empty((C, 2 * C), dtype=torch.float32, device=y.device)
    # not the pair's kernel: not counted in _build.LAUNCHES
    fn = _build.function("pair1t", "pair1t_row_product", _ROW_ARGS)
    with torch.cuda.device(y.device):
        err = fn(w.data_ptr(), y.data_ptr(), n_pix, shift, out.data_ptr(),
                 torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair1t row product: CUDA error {err}")
    return out
