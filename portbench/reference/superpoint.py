"""The plain SuperPoint forward and its detector head, in float32.

SuperPoint as published (DeTone et al. 2018; magicleap
SuperPointPretrainedNetwork `SuperPointNet`): a VGG encoder of four 3x3
conv pairs with 2x2 max pools after the first three, a detector head
convPa (3x3, 256) + convPb (1x1, 65) and a descriptor head convDa (3x3,
256) + convDb (1x1, 256).  Plain NCHW `F.conv2d`, no kernel of the program,
no channels-last layout, no fused pair.

`precision` selects how the convolutions compute:

- "float32": float32 with TF32 off in cuDNN and cuBLAS (the reference);
- "tf32": float32 with TF32 on (the control below float32);
- "fp8": each layer's weights and input activations rounded to float8
  e4m3 with one scale a tensor (amax / 448), then computed in float32 with
  TF32 off (the control below bfloat16).

The head follows the extractor's definitions: the dustbin logit, the
per-cell score exp(max - logsumexp), the in-cell argmax pixel, and the
full-resolution inverted heat map normalised per image to [0, 1].
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

# name, in channels, out channels, kernel size (the published widths)
LAYERS = (
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, 256, 1),
)
CELL = 8
PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


class Maps(NamedTuple):
    """Dense outputs for N images of (H, W)."""

    logits: torch.Tensor      # (N, 65, hc, wc) detector logits
    lse: torch.Tensor         # (N, hc, wc) logsumexp over the 65 channels
    semi_dust: torch.Tensor   # (N, hc, wc) dustbin logit
    dense_dust: torch.Tensor  # (N, hc, wc) dustbin probability
    score: torch.Tensor       # (N, hc, wc) exp(max of 64 - lse)
    cand_uv: torch.Tensor     # (N, hc, wc, 2) int64 in-cell argmax pixel
    cand_valid: torch.Tensor  # (N, hc, wc) score >= conf_thresh
    heat_inv: torch.Tensor    # (N, H, W) normalised inverted heat, [0, 1]
    unit_desc: torch.Tensor   # (N, hc, wc, 256) L2-unit descriptor rows


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 switches set for a block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _conv(x, w, b, precision):
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def forward(images: torch.Tensor, weights: dict, precision: str = "float32"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """images (N, H, W) float32 in [0, 1] -> (logits (N, 65, hc, wc), raw
    descriptors (N, 256, hc, wc)), float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")

    def conv(x, name, relu=True):
        y = _conv(x, weights[f"{name}.weight"], weights[f"{name}.bias"],
                  precision)
        return F.relu(y) if relu else y

    with tf32(precision == "tf32"):
        x = images[:, None].float()
        for pair in (("conv1a", "conv1b"), ("conv2a", "conv2b"),
                     ("conv3a", "conv3b")):
            x = F.max_pool2d(conv(conv(x, pair[0]), pair[1]), 2)
        x = conv(conv(x, "conv4a"), "conv4b")
        logits = conv(conv(x, "convPa"), "convPb", relu=False)
        desc = conv(conv(x, "convDa"), "convDb", relu=False)
    return logits, desc


def head(logits: torch.Tensor, desc: torch.Tensor, conf_thresh: float
         ) -> Maps:
    """The detector and descriptor heads' maps from the raw outputs."""
    N, _, hc, wc = logits.shape
    H, W = hc * CELL, wc * CELL
    lse = torch.logsumexp(logits, dim=1)
    nodust = logits[:, :64]
    semi_dust = logits[:, 64]
    cellmax, idx = nodust.max(dim=1)
    score = torch.exp(cellmax - lse)
    dev = logits.device
    u = torch.arange(wc, device=dev)[None, None, :] * CELL + idx % CELL
    v = torch.arange(hc, device=dev)[None, :, None] * CELL + idx // CELL
    # full-resolution log-probability, clipped at log(1e-3), then each
    # image normalised so that its most likely pixel reads 1 and its least
    # likely 0 (the extractor's `heat_inv`)
    log_eps = torch.log(torch.tensor(1e-3, device=dev))
    heat_log = torch.maximum(nodust - lse[:, None], log_eps)
    full = heat_log.reshape(N, CELL, CELL, hc, wc).permute(
        0, 3, 1, 4, 2).reshape(N, H, W)
    mx = -full.amin((1, 2))
    mn = -full.amax((1, 2))
    heat_inv = (mx[:, None, None] + full) / (mx - mn)[:, None, None]
    d = desc.permute(0, 2, 3, 1)
    unit = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return Maps(logits, lse, semi_dust, torch.exp(semi_dust - lse), score,
                torch.stack([u, v], -1), score >= conf_thresh, heat_inv,
                unit)
