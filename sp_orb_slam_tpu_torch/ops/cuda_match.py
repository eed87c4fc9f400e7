"""The fused init matcher as one Hopper kernel per batch (csrc/match.cu).

The port's counterpart of the TPU kernel sp_orb_slam_tpu/ops/pallas_match.py
`match_init_batch`.  The wrapper launches the kernel for CUDA tensors and
runs the plain PyTorch matcher (ops/matching.py `init_match`) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.ops.matching import TH_LOW, init_match
from sp_orb_slam_tpu_torch.utils.timing import span

_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
         + [ctypes.c_float] * 3)

# a block's tile of (rows, columns), by the index the C entry point takes
TILES = ((128, 128), (64, 32))
PART_BYTES = 12  # a partial: f32 best, f32 second, i32 index


def plan(B: int, M: int, N: int, sms: int) -> int:
    """The tile for a (B, M, N) batch on a card with `sms` SMs: the largest
    whose grid has at least two blocks an SM, else the smallest."""
    for i, (bm, bn) in enumerate(TILES):
        if B * -(-M // bm) * -(-N // bn) >= 2 * sms:
            return i
    return len(TILES) - 1


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def match_init_batch(desc1: torch.Tensor, valid1: torch.Tensor,
                     prev_uv: torch.Tensor, desc2: torch.Tensor,
                     uv2: torch.Tensor, valid2: torch.Tensor, *,
                     window: float = 100, ratio: float = 0.9,
                     th: float = TH_LOW):
    """Batched SearchForInitialization: (B, M, D) x (B, N, D) descriptors.

    Returns (match12 (B, M) int32 into frame-2 keypoints or -1, n_matches
    (B,) int32, match21 (B, N) int32 or -1)."""
    with span("match/init"):
        if desc1.device.type == "cpu":
            return init_match(desc1, valid1, prev_uv, desc2, uv2, valid2,
                              window=window, ratio=ratio, th=th)
        B, M, D = desc1.shape
        N = desc2.shape[1]
        if D % 32:
            raise ValueError(f"match kernel needs D % 32 == 0, got {D}")
        _build.check(desc1, "desc1", torch.float32, (B, M, D))
        _build.check(valid1, "valid1", torch.bool, (B, M))
        _build.check(prev_uv, "prev_uv", torch.float32, (B, M, 2))
        _build.check(desc2, "desc2", torch.float32, (B, N, D))
        _build.check(uv2, "uv2", torch.float32, (B, N, 2))
        _build.check(valid2, "valid2", torch.bool, (B, N))
        if not (B and M and N):
            raise ValueError(f"match kernel needs B, M, N >= 1, got "
                             f"{(B, M, N)}")
        if desc1.data_ptr() % 16 or desc2.data_ptr() % 16:
            # the kernel stages descriptor rows by 16-byte copies
            raise ValueError("match kernel needs 16-byte aligned "
                             "descriptors")
        dev = desc1.device
        tile = plan(B, M, N, _sms(dev.index if dev.index is not None
                                  else torch.cuda.current_device()))
        return _launch(desc1, valid1, prev_uv, desc2, uv2, valid2, tile,
                       window, ratio, th)


def _launch(desc1, valid1, prev_uv, desc2, uv2, valid2, tile, window, ratio,
            th):
    B, M, D = desc1.shape
    N = desc2.shape[1]
    dev = desc1.device
    n_tiles = -(-N // TILES[tile][1])
    match12 = torch.empty((B, M), dtype=torch.int32, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    match21 = torch.empty((B, N), dtype=torch.int32, device=dev)
    # one scratch: column claims (u64), partials, best index (i32), row_ok
    sizes = (B * N * 8, B * M * n_tiles * PART_BYTES, B * M * 4, B * M)
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    colkey, part, best_idx, row_ok = (
        scratch.data_ptr() + sum(sizes[:i]) for i in range(4))
    _build.launch("match", "match_launch", _ARGS, desc1.data_ptr(),
                  prev_uv.data_ptr(), valid1.data_ptr(), desc2.data_ptr(),
                  uv2.data_ptr(), valid2.data_ptr(), match12.data_ptr(),
                  n.data_ptr(), match21.data_ptr(), part, best_idx, row_ok,
                  colkey, B, M, N, D, tile, float(window), float(ratio),
                  float(th), device=dev)
    return match12, n, match21
