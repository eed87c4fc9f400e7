"""The SuperPoint first conv pair as one persistent Hopper kernel
(csrc/pair1.cu).

maxpool2(relu(conv1b(relu(conv1a(x))))) on the bfloat16 path, (B, H, W)
float32 images -> (B, H/2, W/2, 64) bfloat16 NHWC; the port's counterpart of
the TPU kernel sp_orb_slam_tpu/ops/pallas_pair1.py `fused_pair1`.  It is what
`conv_packing="auto"` runs on the bfloat16 CUDA path (extractor.extract);
"pair1t" (ops/cuda_pair1t.py) computes the same function with another
design, so the plain version is that module's: the stock bf16 pair.  The
wrapper launches the kernel for a CUDA tensor and runs the plain version
for a CPU tensor.

The kernel takes conv1b's weights packed as [tap = dy*3+dx][co][ci] bf16
with the 128-byte swizzle applied (`pack_w1b`); `pack` packs the four
tensors, and `packed_weights` packs them once and caches the result, so a
call with the same weights launches the kernel and nothing else.  A caller
that holds its own packing (the SuperPoint module does) passes it as
`packed`, and nothing is packed or looked up.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.ops.cuda_pair1t import fused_pair1t_plain

C = 64
TILE_H, TILE_W = 4, 64   # full-resolution rows x columns of a kernel tile
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
_GRID_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

fused_pair1_plain = fused_pair1t_plain

# packings made by `pack` (a plain count, read by the tests)
packs = 0
_cache: tuple | None = None  # (sources, versions, packed) of the last call


def swizzle_index() -> torch.Tensor:
    """(64, 64) gather index of the 128-byte swizzle: a row of 64 bf16 (128
    bytes, eight 16-byte chunks) stores chunk j of row co at chunk
    j ^ (co % 8); entry [co, p] is the logical column stored at p."""
    co = torch.arange(C)[:, None]
    p = torch.arange(C)[None, :]
    return ((p // 8) ^ (co % 8)) * 8 + p % 8


def pack_w1b(w1b: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> (9, 64, 64) bf16 [tap = dy*3+dx][co][ci], each
    co row swizzled (`swizzle_index`): the K-major, 128-byte swizzled
    layout the kernel copies into shared memory as it is."""
    wb = w1b.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, C, C)
    idx = swizzle_index().to(wb.device).expand(9, C, C)
    return torch.gather(wb, 2, idx).contiguous()


def pack_w1a(w1a: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 1, 3, 3) -> (64, 16) bf16 [co][dy*3+dx], taps 9..15 zero."""
    wa = torch.zeros((C, 16), dtype=torch.bfloat16, device=w1a.device)
    wa[:, :9] = w1a.to(torch.bfloat16).reshape(C, 9)
    return wa


def pack(w1a: torch.Tensor, b1a: torch.Tensor, w1b: torch.Tensor,
         b1b: torch.Tensor, device: torch.device) -> tuple:
    """(w1a (64, 16) bf16, b1a f32, w1b (9, 64, 64) bf16 swizzled, b1b f32)
    on `device`: the weights as the kernels take them."""
    global packs
    packs += 1
    return (pack_w1a(w1a.to(device)),
            b1a.to(device, torch.float32).contiguous(),
            pack_w1b(w1b.to(device)),
            b1b.to(device, torch.float32).contiguous())


def packed_weights(w1a: torch.Tensor, b1a: torch.Tensor, w1b: torch.Tensor,
                   b1b: torch.Tensor, device: torch.device) -> tuple:
    """`pack`'s result, packed once while the same four tensors come at the
    same versions (a model's weights, call after call).  The cache holds
    the sources, so it is never mistaken for another tensor at a reused
    address; inference tensors carry no version counter and pack anew."""
    global _cache
    src = (w1a, b1a, w1b, b1b)
    versions = None
    if not any(t.is_inference() for t in src):
        versions = tuple(t._version for t in src) + (str(device),)
        if (_cache is not None and _cache[1] == versions
                and all(a is b for a, b in zip(_cache[0], src))):
            return _cache[2]
    packed = pack(w1a, b1a, w1b, b1b, device)
    _cache = None if versions is None else (src, versions, packed)
    return packed


def fused_pair1(images: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
                w1b: torch.Tensor, b1b: torch.Tensor, *,
                packed: tuple | None = None) -> torch.Tensor:
    """images (B, H, W) float32 in [0, 1] -> pooled (B, H/2, W/2, 64) bf16.
    Weights are OIHW (64, 1, 3, 3) / (64, 64, 3, 3), biases (64,);
    `packed`, if given, is their `pack` on the images' device, which the
    kernel then reads in place of `packed_weights`'.

    Requires H % 8 == 0 and W % 2 == 0 (EuRoC 752x480, Tsukuba 640x480)."""
    B, H, W = images.shape
    if H % 8 or W % 2:
        raise ValueError(f"pair1 needs H % 8 == 0 and W % 2 == 0, got "
                         f"{H}x{W}")
    if images.device.type == "cpu":
        return fused_pair1_plain(images, w1a, b1a, w1b, b1b)
    _build.check(images, "images", torch.float32, (B, H, W))
    dev = images.device
    wa, ba, wb, bb = (packed if packed is not None else
                      packed_weights(w1a, b1a, w1b, b1b, dev))
    _build.check(wa, "w1a", torch.bfloat16, (C, 16))
    _build.check(wb, "w1b", torch.bfloat16, (9, C, C))
    _build.check(ba, "b1a", torch.float32, (C,))
    _build.check(bb, "b1b", torch.float32, (C,))
    out = torch.empty((B, H // 2, W // 2, C), dtype=torch.bfloat16,
                      device=dev)
    _build.launch("pair1", "pair1_launch", _ARGS, images.data_ptr(),
                  wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                  out.data_ptr(), B, H, W, device=dev)
    return out


def tiles(B: int, H: int, W: int) -> int:
    """Tiles of the kernel for (B, H, W) images: 4 rows x 64 columns each,
    the right band ragged."""
    return B * (H // TILE_H) * -(-W // TILE_W)


def launch_grid(B: int, H: int, W: int,
                device: torch.device) -> tuple[int, int, int]:
    """(grid, resident blocks an SM, SMs) of the persistent launch for
    (B, H, W): the CUDA occupancy calculator at the kernel's shared-memory
    size, and grid = min(tiles, SMs x blocks)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.function("pair1", "pair1_grid", _GRID_ARGS)
    with torch.cuda.device(device):
        err = fn(B, H, W, *(ctypes.addressof(v) for v in vals), None)
    if err != 0:
        raise RuntimeError(f"pair1 grid query: CUDA error {err}")
    return tuple(v.value for v in vals)
