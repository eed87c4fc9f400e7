"""Descriptor sampling as two Hopper kernels (csrc/desc_sparse.cu,
csrc/desc_dense.cu).

The port's counterparts of the TPU kernels sp_orb_slam_tpu/ops/pallas_desc.py
`pallas_sample_descriptors_sparse` (one descriptor per keypoint) and
`pallas_sample_descriptors_dense` (one per cell's candidate).  Each wrapper
launches its kernel for CUDA tensors and runs its plain PyTorch version
for CPU tensors.

The sparse kernel reads the raw descriptor map (convDb's output, float32 or
bfloat16, rows not normalised) and folds in what surrounds the TPU kernel
on the extractor's path: each corner row is cast and L2-normalised as it is
read, and invalid slots are zero.  Its plain version is
`sample_descriptors_sparse_plain`.  It clamps its corners to
[0, wc - 2] x [0, hc - 2] as the TPU kernel does; for keypoints inside the
image (u in [0, W - 1], so u (wc - 1) / W < wc - 1) that clamp never binds.
The dense kernel takes the unit map; its plain version is
models/superpoint.py `sample_descriptors_dense`.
"""

from __future__ import annotations

import ctypes

import torch

from sp_orb_slam_tpu_torch.models.superpoint import (
    sample_descriptors, sample_descriptors_dense, unit_rows)
from sp_orb_slam_tpu_torch.ops import _build

_SPARSE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
_DENSE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
_RAW_TYPES = (torch.float32, torch.bfloat16)
D = 256


def sample_descriptors_sparse_plain(raw: torch.Tensor, uv: torch.Tensor,
                                    valid: torch.Tensor,
                                    image_hw: tuple[int, int]) -> torch.Tensor:
    """The sparse kernel's function in plain PyTorch: the raw map's rows
    cast to float32 and L2-normalised, bilinearly sampled at uv and
    renormalised, invalid slots zero."""
    desc = sample_descriptors(unit_rows(raw.float()), uv, image_hw)
    return torch.where(valid[..., None], desc, 0.0)


def sample_descriptors_sparse(raw: torch.Tensor, uv: torch.Tensor,
                              valid: torch.Tensor,
                              image_hw: tuple[int, int]) -> torch.Tensor:
    """Batched sparse sampling from the raw map: raw (B, hc, wc, 256)
    float32 or bfloat16 (convDb's output, rows not normalised), uv (B, K,
    2) float32 pixel coords of an (H, W) image, valid (B, K) bool ->
    (B, K, 256) float32 unit descriptors, zero on invalid slots."""
    if raw.device.type == "cpu":
        return sample_descriptors_sparse_plain(raw, uv, valid, image_hw)
    if raw.dtype not in _RAW_TYPES:
        raise ValueError(f"raw: expected float32 or bfloat16, got "
                         f"{raw.dtype}")
    if raw.dim() != 4 or raw.shape[-1] != D or min(raw.shape[1:3]) < 2:
        raise ValueError(f"desc_sparse kernel needs a (B, hc, wc, {D}) map "
                         f"with hc, wc >= 2, got {tuple(raw.shape)}")
    B, hc, wc, _ = raw.shape
    K = uv.shape[1]
    _build.check(raw, "raw", raw.dtype, (B, hc, wc, D))
    _build.check(uv, "uv", torch.float32, (B, K, 2))
    _build.check(valid, "valid", torch.bool, (B, K))
    if raw.data_ptr() % 16 or uv.data_ptr() % 8:
        raise ValueError("desc_sparse kernel needs raw on 16 bytes and uv "
                         "on 8 (its vector loads)")
    out = torch.empty((B, K, D), dtype=torch.float32, device=raw.device)
    H, W = image_hw
    _build.launch("desc_sparse", "desc_sparse_launch", _SPARSE_ARGS,
                  raw.data_ptr(), uv.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), B, K, hc, wc, H, W,
                  int(raw.dtype == torch.bfloat16), device=raw.device)
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
