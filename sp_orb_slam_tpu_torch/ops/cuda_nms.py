"""Greedy grid NMS as one Hopper kernel per batch (csrc/nms.cu).

The port's counterpart of the TPU kernel sp_orb_slam_tpu/ops/pallas_nms.py
`batched_grid_nms`.  The wrapper launches the kernel for a CUDA tensor and
runs the plain PyTorch fixed point (ops/nms.py `greedy_grid_nms`) for a CPU
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.ops.nms import greedy_grid_nms

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
MAX_WORDS = 1024        # a thread of the block per 32-column word
STATIC_SMEM = 16        # csrc/nms.cu's static shared memory: the mbarrier
                        # and the final state's index
CLUSTER = 8             # blocks an image at a small batch (csrc/nms.cu: 1
                        # or 8)


def footprint(hc: int, wc: int) -> tuple[int, int]:
    """(words, shared-memory bytes) of one image's cell grid in the kernel:
    its rows of 32-column words, and csrc/nms.cu's `Layout` (score, uv and
    valid staged; a zero-bordered grid of word slots, 64 bytes of masks
    and two 8-byte states each) with its static shared memory."""
    n, nwr = hc * wc, -(-wc // 32)
    staged = sum(-(-b // 16) * 16 for b in (4 * n, 8 * n, n))
    return hc * nwr, (staged + (hc + 2) * (nwr + 2) * (64 + 2 * 8)
                      + STATIC_SMEM)


def cluster_size(B: int, sms: int) -> int:
    """Blocks an image: CLUSTER where the B clusters take at most half of
    the `sms` SMs (B <= 8 on the H100's 132), else 1 (PERF.md has both at
    B = 1, 8 and 32)."""
    return CLUSTER if 2 * CLUSTER * B <= sms else 1


def _launch(score, cand_uv, cand_valid, dist, iters, cluster):
    B, hc, wc = score.shape
    kept = torch.empty((B, hc, wc), dtype=torch.bool, device=score.device)
    _build.launch("nms", "nms_launch", _ARGS, score.data_ptr(),
                  cand_uv.data_ptr(), cand_valid.data_ptr(), kept.data_ptr(),
                  B, hc, wc, dist, iters, cluster, device=score.device)
    return kept


def batched_grid_nms(score: torch.Tensor, cand_uv: torch.Tensor,
                     cand_valid: torch.Tensor, *, dist: int = 4,
                     iters: int = 16) -> torch.Tensor:
    """(B, hc, wc) score / (B, hc, wc, 2) int32 cand_uv / bool cand_valid
    -> (B, hc, wc) bool survivor mask, equal to `greedy_grid_nms`."""
    if score.device.type == "cpu":
        return greedy_grid_nms(score, cand_uv, cand_valid, dist=dist,
                               iters=iters)
    B, hc, wc = score.shape
    _build.check(score, "score", torch.float32, (B, hc, wc))
    _build.check(cand_uv, "cand_uv", torch.int32, (B, hc, wc, 2))
    _build.check(cand_valid, "cand_valid", torch.bool, (B, hc, wc))
    props = torch.cuda.get_device_properties(score.device)
    words, smem = footprint(hc, wc)
    limit = props.shared_memory_per_block_optin
    if words > MAX_WORDS or smem > limit:
        raise ValueError(f"nms kernel: a {hc}x{wc} cell grid needs {words} "
                         f"words (at most {MAX_WORDS}) and {smem} B of "
                         f"shared memory (at most {limit})")
    return _launch(score, cand_uv, cand_valid, dist, iters,
                   cluster_size(B, props.multi_processor_count))
