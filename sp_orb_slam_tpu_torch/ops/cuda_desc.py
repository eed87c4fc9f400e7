"""Descriptor sampling as two Hopper kernels (csrc/desc_sparse.cu,
csrc/desc_dense.cu).

The port's counterparts of the TPU kernels sp_orb_slam_tpu/ops/pallas_desc.py
`pallas_sample_descriptors_sparse` (one descriptor per keypoint) and
`pallas_sample_descriptors_dense` (one per cell's candidate).  Each wrapper
launches its kernel for CUDA tensors and runs its plain PyTorch version
for CPU tensors: models/superpoint.py `sample_descriptors` and
`sample_descriptors_dense`.  The sparse kernel clamps its corners to
[0, wc - 2] x [0, hc - 2] as the TPU kernel does; for keypoints inside the
image (u in [0, W - 1], so u (wc - 1) / W < wc - 1) that clamp never binds
and it computes `sample_descriptors`.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.models.superpoint import (
    sample_descriptors, sample_descriptors_dense)
from sp_orb_slam_tpu_torch.ops import _build

_SPARSE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
_DENSE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
D = 256


def sample_descriptors_sparse(coarse: torch.Tensor, uv: torch.Tensor,
                              image_hw: tuple[int, int]) -> torch.Tensor:
    """Batched sparse sampling: coarse (B, hc, wc, 256) unit rows, uv
    (B, K, 2) with K % 8 == 0 -> (B, K, 256) unit-norm descriptors (invalid
    slots included; mask outside)."""
    if coarse.device.type == "cpu":
        return sample_descriptors(coarse, uv, image_hw)
    B, hc, wc, Dd = coarse.shape
    K = uv.shape[1]
    if Dd != D or K % 8 or hc < 2 or wc < 2:
        raise ValueError(f"desc_sparse kernel needs D == {D}, K % 8 == 0 and "
                         f"a grid of at least 2x2, got D={Dd}, K={K}, "
                         f"{hc}x{wc}")
    _build.check(coarse, "coarse", torch.float32, (B, hc, wc, D))
    _build.check(uv, "uv", torch.float32, (B, K, 2))
    out = torch.empty((B, K, D), dtype=torch.float32, device=coarse.device)
    H, W = image_hw
    _build.launch("desc_sparse", "desc_sparse_launch", _SPARSE_ARGS,
                  coarse.data_ptr(), uv.data_ptr(), out.data_ptr(), B, K,
                  hc, wc, H, W, device=coarse.device)
    return out


def sample_descriptors_dense_batch(coarse: torch.Tensor,
                                   cand_uv: torch.Tensor,
                                   image_hw: tuple[int, int]) -> torch.Tensor:
    """Batched dense sampling: coarse (B, hc, wc, 256) unit rows, cand_uv
    (B, hc, wc, 2) int32 -> (B, hc, wc, 256) unit-norm descriptors of every
    cell's candidate."""
    if coarse.device.type == "cpu":
        return sample_descriptors_dense(coarse, cand_uv, image_hw)
    B, hc, wc, Dd = coarse.shape
    if Dd != D:
        raise ValueError(f"desc_dense kernel needs D == {D}, got {Dd}")
    _build.check(coarse, "coarse", torch.float32, (B, hc, wc, D))
    _build.check(cand_uv, "cand_uv", torch.int32, (B, hc, wc, 2))
    out = torch.empty_like(coarse)
    H, W = image_hw
    _build.launch("desc_dense", "desc_dense_launch", _DENSE_ARGS,
                  coarse.data_ptr(), cand_uv.data_ptr(), out.data_ptr(), B,
                  hc, wc, H, W, device=coarse.device)
    return out
