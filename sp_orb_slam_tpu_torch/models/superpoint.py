"""SuperPoint-style frontend as a batched PyTorch module.

The port of the JAX package's models/superpoint.py (reference SPFrontend,
src/cv/sp_extractor.cpp:23-158): a shared VGG encoder of 4 conv pairs
(64, 64, 128, 128 channels) with 2x2 max pools after pairs 1-3, a detector
head convPa(256, 3x3) + convPb(65, 1x1) and a descriptor head
convDa(256, 3x3) + convDb(256, 1x1), L2-normalised.  The detector head is
finished in the log-sum-exp form: per-cell score and in-cell argmax pixel
(`cand_uv`), the dustbin maps, and the full-resolution heat map normalised
to [0, 1] (`heat_inv` peaks at keypoints).  `train_forward` is the
training forward (semi logits and unit coarse descriptors, with gradients),
and `init_params` draws a fresh state.

Public layouts are the JAX package's: (B, hc, wc) cell maps, NHWC
`coarse_desc` (B, hc, wc, 256), `cand_uv` (B, hc, wc, 2).  Inside, the conv
stack runs NCHW tensors in channels-last memory, so the NHWC output of the
fused first pair (ops/cuda_pair1t.py or ops/cuda_pair1.py) feeds cuDNN
without a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sp_orb_slam_tpu_torch.ops import cuda_pair1, cuda_pair1t
from sp_orb_slam_tpu_torch.utils.precision import full_f32

# encoder/head channel plan (sp_extractor.cpp:16-21)
C1, C2, C3, C4, C5, D1 = 64, 64, 128, 128, 256, 256

LAYERS = (
    # name, in_ch, out_ch, ksize
    ("conv1a", 1, C1, 3),
    ("conv1b", C1, C1, 3),
    ("conv2a", C1, C2, 3),
    ("conv2b", C2, C2, 3),
    ("conv3a", C2, C3, 3),
    ("conv3b", C3, C3, 3),
    ("conv4a", C3, C4, 3),
    ("conv4b", C4, C4, 3),
    ("convPa", C4, C5, 3),
    ("convPb", C5, 65, 1),
    ("convDa", C4, C5, 3),
    ("convDb", C5, D1, 1),
)

PAIRS = (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"))
# the JAX package's space-to-depth lowerings of the first 1-3 pairs: the
# same function as "none", which is faster on the H100 (PERF.md), so they
# run as "none"
S2D = ("s2d", "s2d2", "s2d3")


class FrontendOut(NamedTuple):
    """Dense frontend outputs for a batch of B images (H, W)."""

    semi_dust: torch.Tensor    # (B, hc, wc)  dustbin logits
    dense_dust: torch.Tensor   # (B, hc, wc)  dustbin probability
    score: torch.Tensor        # (B, hc, wc)  per-cell max probability
    cand_uv: torch.Tensor      # (B, hc, wc, 2) int32 in-cell argmax (u, v)
    cand_valid: torch.Tensor   # (B, hc, wc)  score >= conf_thresh
    # (B, hc, wc, 256) L2-normalised descriptors; with raw_desc=True the
    # raw convDb output in the compute dtype (a contiguous view)
    coarse_desc: torch.Tensor
    heat: torch.Tensor | None      # (B, H, W) normalised "coldness" in [0, 1]
    heat_inv: torch.Tensor | None  # (B, H, W) 1 - heat (peaks at keypoints)


def init_params(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh float32 state dict on the CPU: Kaiming-uniform weights with
    bound sqrt(6 / fan_in) and biases with bound 1 / sqrt(fan_in) (the
    JAX package's `init_params`), drawn layer by layer, weight then bias,
    from `generator`."""
    state = {}
    for name, cin, cout, k in LAYERS:
        fan_in = cin * k * k
        for key, shape, bound in (("weight", (cout, cin, k, k),
                                   float(np.sqrt(6.0 / fan_in))),
                                  ("bias", (cout,),
                                   float(1.0 / np.sqrt(fan_in)))):
            state[f"{name}.{key}"] = torch.empty(shape).uniform_(
                -bound, bound, generator=generator)
    return state


class SuperPoint(nn.Module):
    """The 12 convs of `LAYERS`, named as in the reference checkpoint
    (`conv1a.weight`, ...), built from a state dict (models/weights.py);
    the module takes the state's tensors and their device.  For inference
    the weights are fixed once built: their copy in each compute dtype and
    device is cast on first use, and so is the fused first pair's packing
    of conv1a and conv1b on each card.
    `train_forward` reads the parameters themselves; a trained state goes
    into a new module."""

    def __init__(self, state: dict[str, torch.Tensor]):
        super().__init__()
        for name, cin, cout, k in LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=(k - 1) // 2,
                                          device="meta"))
        self.load_state_dict(state, assign=True)
        self._cast: dict[tuple, dict[str, tuple]] = {}
        self._packed: dict[torch.device, tuple] = {}

    def _weights(self, x: torch.Tensor) -> dict[str, tuple]:
        """{name: (weight channels-last, bias)} in x's dtype and on x's
        device, cast once."""
        key = (x.dtype, x.device)
        if key not in self._cast:
            with torch.inference_mode(False), torch.no_grad():
                self._cast[key] = {
                    name: (getattr(self, name).weight.to(
                        x.device, x.dtype, memory_format=torch.channels_last),
                        getattr(self, name).bias.to(x.device, x.dtype))
                    for name, *_ in LAYERS}
        return self._cast[key]

    def _pair1_packed(self, device: torch.device) -> tuple:
        """conv1a and conv1b packed for the fused first pair's kernels on
        `device` (ops/cuda_pair1.py `pack`), once.  The module holds them:
        a captured CUDA graph reads them, and no other module's call may
        repack or free them."""
        if device not in self._packed:
            with torch.inference_mode(False), torch.no_grad():
                self._packed[device] = cuda_pair1.pack(
                    self.conv1a.weight, self.conv1a.bias,
                    self.conv1b.weight, self.conv1b.bias, device)
        return self._packed[device]

    @staticmethod
    def _conv_wb(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
        y = F.conv2d(x, w, b, padding=w.shape[-1] // 2)
        return y.relu_() if relu else y

    def _conv(self, x: torch.Tensor, name: str,
              relu: bool = True) -> torch.Tensor:
        return self._conv_wb(x, *self._weights(x)[name], relu)

    def train_forward(self, images: torch.Tensor):
        """images (B, H, W) float32 in [0, 1] -> (semi logits (B, hc, wc,
        65), coarse descriptors (B, hc, wc, 256) divided by max(norm,
        1e-8)): the forward without the inference post-processing, on the
        module's parameters, so gradients reach them (the JAX package's
        train/superpoint_train.py `train_forward`)."""
        def conv(x, name, relu=True):
            m = getattr(self, name)
            return self._conv_wb(x, m.weight, m.bias, relu)

        x = images[:, None]
        for na, nb in PAIRS:
            x = F.max_pool2d(conv(conv(x, na), nb), 2)
        x = conv(conv(x, "conv4a"), "conv4b")
        semi = conv(conv(x, "convPa"), "convPb", relu=False)
        coarse = conv(conv(x, "convDa"), "convDb", relu=False)
        coarse = coarse / torch.linalg.vector_norm(
            coarse, dim=1, keepdim=True).clamp_min(1e-8)
        return semi.permute(0, 2, 3, 1), coarse.permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor, *, conf_thresh: float = 0.007,
                cell: int = 8, conv_packing: str = "none",
                with_heat: bool = True, with_heat_inv: bool = True,
                compute_dtype: torch.dtype = torch.float32,
                raw_desc: bool = False) -> FrontendOut:
        """images (B, H, W) float32 in [0, 1].

        The conv stack runs in `compute_dtype` (bfloat16 for speed; float32
        runs without TF32, the counterpart of the JAX package's
        `Precision.HIGHEST`); heads and probabilities finish in float32.
        `conv_packing` "pair1t" or "pair1" runs the first conv pair as one
        fused kernel (bfloat16 only; two designs of the same function,
        ops/cuda_pair1t.py and ops/cuda_pair1.py); "s2d", "s2d2" and "s2d3",
        the JAX package's space-to-depth lowerings of the same function,
        run as "none".  `raw_desc` returns convDb's output as it is
        written (channels-last, so its NHWC view is contiguous) in place of
        the unit `coarse_desc`, for the fused sampler
        (ops/cuda_desc.py `sample_descriptors_sparse`), which casts and
        normalises only the rows it reads."""
        with full_f32():
            return self._forward(images, conf_thresh, cell, conv_packing,
                                 with_heat, with_heat_inv, compute_dtype,
                                 raw_desc)

    def _forward(self, images, conf_thresh, cell, conv_packing, with_heat,
                 with_heat_inv, compute_dtype, raw_desc) -> FrontendOut:
        B, H, W = images.shape
        hc, wc = H // cell, W // cell
        if conv_packing in ("pair1t", "pair1"):
            if compute_dtype != torch.bfloat16:
                raise ValueError(f"{conv_packing} is the bfloat16 path")
            fused = (cuda_pair1t.fused_pair1t if conv_packing == "pair1t"
                     else cuda_pair1.fused_pair1)
            packed = (self._pair1_packed(images.device)
                      if images.device.type == "cuda" else None)
            x = fused(images, self.conv1a.weight, self.conv1a.bias,
                      self.conv1b.weight, self.conv1b.bias,
                      packed=packed).permute(0, 3, 1, 2)
            pairs = PAIRS[1:]
        elif conv_packing == "none" or conv_packing in S2D:
            x = images[:, None].to(compute_dtype).contiguous(
                memory_format=torch.channels_last)
            pairs = PAIRS
        else:
            raise ValueError(f"unknown conv_packing {conv_packing!r}")
        for na, nb in pairs:
            x = F.max_pool2d(self._conv(self._conv(x, na), nb), 2)
        x = self._conv(self._conv(x, "conv4a"), "conv4b")

        semi = self._conv(self._conv(x, "convPa"), "convPb", relu=False)
        semi = semi.float().permute(0, 2, 3, 1)           # (B, hc, wc, 65)
        coarse = self._conv(self._conv(x, "convDa"), "convDb", relu=False)
        coarse = coarse.permute(0, 2, 3, 1)               # (B, hc, wc, 256)
        if not raw_desc:
            coarse = unit_rows(coarse.float())

        # log-sum-exp head (the JAX package's round-4 form): softmax is
        # monotone in the logits, so its max / argmax / dustbin / clipped
        # log come from the logits and the (B, hc, wc, 65) softmax never
        # exists
        lse = torch.logsumexp(semi, dim=-1)
        semi_nodust = semi[..., :64]  # channel c <-> in-cell (c // 8, c % 8)
        semi_dust = semi[..., 64]
        dense_dust = torch.exp(semi_dust - lse)
        cellmax = semi_nodust.amax(-1)
        score = torch.exp(cellmax - lse)
        idx = semi_nodust.argmax(-1).to(torch.int32)
        dy, dx = idx // cell, idx % cell
        ar_v = torch.arange(hc, dtype=torch.int32, device=images.device)
        ar_u = torch.arange(wc, dtype=torch.int32, device=images.device)
        cand_uv = torch.stack([ar_u[None, None, :] * cell + dx,
                               ar_v[None, :, None] * cell + dy], dim=-1)
        cand_valid = score >= conf_thresh

        heat = heat_inv = None
        if with_heat or with_heat_inv:
            # full-res log-prob heat + the host wrapper's normalisation
            # (sp_extractor.cpp:128-131, 466-478), per-image min / max from
            # cell-level reductions (clip is monotone)
            log_eps = log_floor(semi)
            heat_log = torch.maximum(semi_nodust - lse[..., None], log_eps)
            mn = -torch.maximum(cellmax - lse, log_eps).amax((1, 2))
            mx = -torch.maximum(semi_nodust.amin(-1) - lse,
                                log_eps).amin((1, 2))
            mn, mx = mn.view(B, 1, 1), mx.view(B, 1, 1)
            # pixel_shuffle(x, 8): out[v*8+dy, u*8+dx] = in[dy*8+dx] @ (v, u)
            heat_full = heat_log.reshape(B, hc, wc, cell, cell).permute(
                0, 1, 3, 2, 4).reshape(B, H, W)
            heat_inv = (mx + heat_full) / (mx - mn)
            if with_heat:
                heat = 1.0 - heat_inv
        return FrontendOut(semi_dust, dense_dust, score, cand_uv, cand_valid,
                           coarse, heat, heat_inv)


# the heat map's floor: the float32 log of float32 1e-3, computed once on
# the host
LOG_EPS = float(torch.tensor(1e-3, dtype=torch.float32).log())


def log_floor(like: torch.Tensor) -> torch.Tensor:
    """LOG_EPS as a float32 scalar tensor on `like`'s device, made there by a
    fill: nothing crosses the bus and the host does not wait."""
    return like.new_full((), LOG_EPS, dtype=torch.float32)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of the last axis divided by its L2 norm (the descriptor
    head's normalisation; a zero row gives NaN, as in the JAX package)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def sample_descriptors(coarse: torch.Tensor, uv: torch.Tensor,
                       image_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinearly sample L2-renormalised descriptors at pixel coords.

    torch.grid_sampler_2d(align_corners=True) semantics with grid =
    uv / (size / 2) - 1 (sp_extractor.cpp:134-148): the sampling location in
    the coarse map is x_c = u (wc - 1) / W, y_c = v (hc - 1) / H.

    coarse (B, hc, wc, D); uv (B, K, 2) float pixel coords -> (B, K, D)."""
    H, W = image_hw
    B, hc, wc, D = coarse.shape
    K = uv.shape[1]
    gx = uv[..., 0] * (wc - 1) / W
    gy = uv[..., 1] * (hc - 1) / H
    x0 = gx.floor().to(torch.int32).clamp(0, wc - 1)
    y0 = gy.floor().to(torch.int32).clamp(0, hc - 1)
    x1 = (x0 + 1).clamp(max=wc - 1)
    y1 = (y0 + 1).clamp(max=hc - 1)
    du = (gx - x0.to(gx.dtype))[..., None]
    dv = (gy - y0.to(gy.dtype))[..., None]
    flat = coarse.reshape(B, hc * wc, D)

    def corner(yy, xx):
        rows = (yy * wc + xx).long()[..., None].expand(B, K, D)
        return torch.gather(flat, 1, rows)

    desc = ((1 - du) * (1 - dv) * corner(y0, x0)
            + du * (1 - dv) * corner(y0, x1)
            + (1 - du) * dv * corner(y1, x0)
            + du * dv * corner(y1, x1))
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp_min(1e-12)


def sample_descriptors_dense(coarse: torch.Tensor, cand_uv: torch.Tensor,
                             image_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear descriptor sampling for every cell's candidate keypoint as a
    9-tap stencil (the plain version of ops/cuda_desc.py's dense kernel).

    The candidate of cell (i, j) samples at x_c = u (wc - 1) / W with u in
    [8j, 8j + 7], inside (j - 1, j + 1): its four bilinear corners fall in
    the 3x3 cell neighbourhood.  Each corner weight is folded onto the
    (dy, dx) shift it lands on, then the nine edge-clamped shifts of the
    map are summed.  coarse (B, hc, wc, D); cand_uv (B, hc, wc, 2) ->
    (B, hc, wc, D) unit rows, equal to `sample_descriptors` at each cell's
    candidate."""
    H, W = image_hw
    B, hc, wc, D = coarse.shape
    gx = cand_uv[..., 0].float() * (wc - 1) / W
    gy = cand_uv[..., 1].float() * (hc - 1) / H
    x0 = gx.floor().long().clamp(0, wc - 1)
    y0 = gy.floor().long().clamp(0, hc - 1)
    x1 = (x0 + 1).clamp(max=wc - 1)
    y1 = (y0 + 1).clamp(max=hc - 1)
    du = gx - x0
    dv = gy - y0
    ci = torch.arange(hc, device=coarse.device)[:, None]
    cj = torch.arange(wc, device=coarse.device)[None, :]
    corners = ((y0, x0, (1 - du) * (1 - dv)), (y0, x1, du * (1 - dv)),
               (y1, x0, (1 - du) * dv), (y1, x1, du * dv))
    desc = torch.zeros_like(coarse)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = sum(((yy - ci == dy) & (xx - cj == dx)).float() * wt
                    for yy, xx, wt in corners)
            rows = (ci + dy).clamp(0, hc - 1)
            cols = (cj + dx).clamp(0, wc - 1)
            desc = desc + w[..., None] * coarse[:, rows, cols]
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp_min(1e-12)
