"""The full learned feature extractor over a batch of images.

The port of the JAX package's extractor.py (reference
SPExtractor::operator(), src/cv/sp_extractor.cpp:361-514): frontend forward
+ grid NMS + score cap + raster emission with occ_grid + descriptor sampling
+ covariance, batched over streams.  On a CUDA device the hand-written
kernels carry the path: the fused first conv pair (bfloat16), the NMS fixed
point, the descriptor sampling and the covariance fill (ops/cuda_*.py); the
plain PyTorch versions run on the CPU.  `make_extractor`'s closure replays
the whole extraction on a CUDA device as one captured CUDA graph for each
input shape that recurs (`utils/graphs.py`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.models.superpoint import (
    SuperPoint, sample_descriptors, sample_descriptors_dense)
from sp_orb_slam_tpu_torch.ops import cuda_cov, cuda_desc, cuda_nms
from sp_orb_slam_tpu_torch.ops import covariance as cov_ops
from sp_orb_slam_tpu_torch.ops import nms as nms_ops
from sp_orb_slam_tpu_torch.utils.graphs import GraphRunner
from sp_orb_slam_tpu_torch.utils.timing import span


class Features(NamedTuple):
    """Per-frame learned features, fixed capacity K, batched over streams B."""

    uv: torch.Tensor          # (B, K, 2) float32 keypoint pixel coords
    score: torch.Tensor       # (B, K)
    response: torch.Tensor    # (B, K) heat_inv at the keypoint
    valid: torch.Tensor       # (B, K) bool
    desc: torch.Tensor        # (B, K, 256) unit descriptors
    cov2: torch.Tensor        # (B, K, 2)
    cov2_inv: torch.Tensor    # (B, K, 2)
    occ_grid: torch.Tensor    # (B, hc, wc) int32 kp index per cell, -1 empty
    dense_dust: torch.Tensor  # (B, hc, wc) dustbin probability (the dust map)
    semi_dust: torch.Tensor   # (B, hc, wc) dustbin logits
    heat: torch.Tensor | None      # (B, H, W) normalised heat ("coldness")
    heat_inv: torch.Tensor | None  # (B, H, W) 1 - heat
    count: torch.Tensor       # (B,) int32


def resolve_conv_packing(conv_packing: str, compute_dtype: torch.dtype,
                         device: torch.device, H: int, W: int) -> str:
    """The first conv pair's route: "auto" is the persistent pair1 kernel
    on the bfloat16 path on a CUDA device where it applies (H % 8 == 0,
    W % 2 == 0), else "none"; any other value is returned as given."""
    if conv_packing != "auto":
        return conv_packing
    return ("pair1" if (compute_dtype == torch.bfloat16
                        and device.type == "cuda" and H % 8 == 0
                        and W % 2 == 0) else "none")


def extract(model: SuperPoint, images: torch.Tensor, *, num_features: int,
            max_keypoints: int, conf_thresh: float = 0.007,
            nms_dist: int = 4, border: int = 8, nms_iters: int = 16,
            cov_radius: int = 8, cov_iters: int = 16,
            cov_method: str = "auto", nms_method: str = "auto",
            desc_method: str = "auto", conv_packing: str = "auto",
            with_heat: bool = False, with_heat_inv: bool = True,
            emission: str = "sort", heat_shuffle: str = "slices",
            compute_dtype: torch.dtype = torch.float32) -> Features:
    """images: (B, H, W) float32 in [0, 1], on the model's device.

    Method choices: `nms_method` "cuda" (kernel) or "xla" (plain fixed
    point), `cov_method` "cuda" (kernel), "windowed" (plain fill), "dense"
    (the plain dense-ownership fill, ops/covariance.dense_covariance) or
    "none" (unit covariance, zero response), `conv_packing`
    "pair1" or "pair1t" (the two fused first-pair kernels, bfloat16,
    H % 8 == 0 and W % 2 == 0) or "none" ("s2d", "s2d2" and "s2d3", the
    JAX package's space-to-depth lowerings, run as "none"); "auto" picks the
    kernels on a CUDA device (pair1, the persistent kernel, faster than
    pair1t on the H100 at B=1, 8 and 32 (PERF.md), when bfloat16,
    H % 8 == 0 and W % 2 == 0) and the plain versions on the CPU.
    `desc_method`: "gather" (plain 4-corner sampling at each keypoint),
    "pallas_sparse" (the sparse sampling kernel, on the raw convDb map:
    the forward's `raw_desc`; the kernel casts and normalises the corner
    rows it reads and zeroes invalid slots, so no pass over the whole map
    or the output runs outside it; its plain version on the CPU), "dense"
    (plain 9-tap stencil at every cell's candidate, then each keypoint's
    own cell row), "pallas" (the dense kernel, then the row pick); "auto"
    is "pallas_sparse" on a CUDA device and "gather" on the CPU.  All four
    agree to float32 rounding.  `emission` ("sort" | "scatter") and
    `heat_shuffle` ("slices" | "transpose") name the JAX package's XLA
    lowerings of the raster emission and the heat map's pixel shuffle,
    whose outputs are equal: each value is checked and the one result
    computed."""
    if cov_radius > border:
        # the border filter is what keeps the (2r+1)^2 covariance window
        # centred on its keypoint; a clipped window de-centres the fill
        raise ValueError(f"cov_radius ({cov_radius}) must be <= border "
                         f"({border})")
    B, H, W = images.shape
    on_cuda = images.device.type == "cuda"
    conv_packing = resolve_conv_packing(conv_packing, compute_dtype,
                                        images.device, H, W)
    if cov_method == "auto":
        cov_method = "cuda" if on_cuda else "windowed"
    if nms_method == "auto":
        nms_method = "cuda" if on_cuda else "xla"
    if desc_method == "auto":
        desc_method = "pallas_sparse" if on_cuda else "gather"
    for name, value, known in (
            ("desc_method", desc_method,
             ("gather", "pallas_sparse", "dense", "pallas")),
            ("cov_method", cov_method, ("cuda", "windowed", "dense", "none")),
            ("emission", emission, ("sort", "scatter")),
            ("heat_shuffle", heat_shuffle, ("slices", "transpose"))):
        if value not in known:
            raise ValueError(f"unknown {name} {value!r}")

    with span("extract/forward"):
        out = model(images, conf_thresh=conf_thresh,
                    conv_packing=conv_packing, with_heat=with_heat,
                    with_heat_inv=with_heat_inv or cov_method != "none",
                    compute_dtype=compute_dtype,
                    raw_desc=desc_method == "pallas_sparse")

    with span("extract/nms"):
        if nms_method == "cuda":
            alive = cuda_nms.batched_grid_nms(out.score, out.cand_uv,
                                              out.cand_valid, dist=nms_dist,
                                              iters=nms_iters)
        elif nms_method == "xla":
            alive = nms_ops.greedy_grid_nms(out.score, out.cand_uv,
                                            out.cand_valid, dist=nms_dist,
                                            iters=nms_iters)
        else:
            raise ValueError(f"unknown nms_method {nms_method!r}")
    with span("extract/select"):
        kps = nms_ops.select_keypoints(
            out.score, out.cand_uv, out.cand_valid,
            num_features=num_features, max_keypoints=max_keypoints,
            image_hw=(H, W), dist=nms_dist, border=border,
            nms_iters=nms_iters, alive=alive)

    with span("extract/desc"):
        if desc_method in ("dense", "pallas"):
            # every cell's candidate, then each keypoint's own cell row (a
            # keypoint's uv is its cell's candidate uv)
            if desc_method == "pallas":
                dense = cuda_desc.sample_descriptors_dense_batch(
                    out.coarse_desc.contiguous(), out.cand_uv.contiguous(),
                    (H, W))
            else:
                dense = sample_descriptors_dense(out.coarse_desc,
                                                 out.cand_uv, (H, W))
            hc, wc = H // 8, W // 8
            cy = (kps.uv[..., 1].long() // 8).clamp(0, hc - 1)
            cx = (kps.uv[..., 0].long() // 8).clamp(0, wc - 1)
            rows = (cy * wc + cx)[..., None].expand(-1, -1, dense.shape[-1])
            desc = torch.gather(dense.reshape(B, hc * wc, -1), 1, rows)
        elif desc_method == "pallas_sparse":
            # the raw map: the kernel casts, normalises and masks as it
            # reads
            desc = cuda_desc.sample_descriptors_sparse(
                out.coarse_desc, kps.uv.contiguous(), kps.valid.contiguous(),
                (H, W))
        else:
            desc = sample_descriptors(out.coarse_desc, kps.uv, (H, W))
        if desc_method != "pallas_sparse":
            desc = torch.where(kps.valid[..., None], desc, 0.0)

    with span("extract/cov"):
        if cov_method == "cuda":
            cov2, cov2_inv, response = cuda_cov.batched_covariance(
                out.heat_inv, kps.uv, kps.valid, radius=cov_radius,
                iters=cov_iters)
        elif cov_method == "windowed":
            cov2, cov2_inv, response = cov_ops.keypoint_covariance(
                out.heat_inv, kps.uv, kps.valid, radius=cov_radius,
                iters=cov_iters)
        elif cov_method == "dense":
            cov2, cov2_inv, response = cov_ops.dense_covariance(
                out.heat_inv, kps.occ_grid, kps.uv, kps.valid,
                iters=cov_iters)
        else:  # "none": unit covariance, zero response
            cov2 = cov2_inv = torch.ones(kps.uv.shape, device=images.device)
            response = torch.zeros(kps.valid.shape, device=images.device)

    return Features(kps.uv, kps.score, response, kps.valid, desc, cov2,
                    cov2_inv, kps.occ_grid, out.dense_dust, out.semi_dust,
                    out.heat, out.heat_inv if with_heat_inv else None,
                    kps.count)


def extract_options(cfg: Config) -> dict:
    """The keywords `make_extractor`'s closure calls `extract` with."""
    ex = cfg.extractor
    return dict(
        num_features=cfg.tracking.num_features,
        max_keypoints=cfg.runtime.max_keypoints,
        conf_thresh=ex.conf_thresh, nms_dist=ex.nms_dist,
        border=ex.border, nms_iters=ex.nms_iters,
        cov_radius=ex.cov_window, cov_iters=ex.cov_iters,
        cov_method=ex.cov_method, nms_method=ex.nms_method,
        desc_method=ex.desc_method, conv_packing=ex.conv_packing,
        with_heat=(cfg.tracking.coarse_method == "heat"),
        with_heat_inv=False,  # no production consumer
        compute_dtype=(torch.bfloat16 if ex.dtype == "bfloat16"
                       else torch.float32))


def _images(images) -> tuple:
    """`make_extractor`'s input as the runner's inputs: the batch as a
    float32 tensor, on the host when handed in from the host."""
    return (torch.as_tensor(images, dtype=torch.float32),)


def make_extractor(cfg: Config, params, device: str | torch.device = "cuda"):
    """The extractor closure for a config's operating point.

    `params` is a state dict (models/weights.py).  The model and every call
    run on `device`, which defaults to the card; with no card this raises
    rather than running on the CPU (pass `device="cpu"` for that).  On the
    card a shape that recurs is replayed as a CUDA graph (`GraphRunner`);
    the closure's `calls`, `uploads` and `graphs` are its runner's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the extractor on the CPU")
    model = SuperPoint(params).to(dev).eval()
    runner = GraphRunner(functools.partial(extract, model), dev, "extract",
                         _images)

    def run(images) -> Features:
        with span("extract"):
            return runner(images, extract_options(cfg))

    run.calls = runner.calls
    run.uploads = runner.uploads
    run.graphs = runner.graphs
    return run
