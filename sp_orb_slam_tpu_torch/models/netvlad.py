"""NetVLAD-style global descriptor computed in-process from SP descriptors.

The port of the JAX package's models/netvlad.py.  The reference ships
NetVLAD as an empty stub and loads precomputed 4096-d descriptors from disk
(cv/netvlad.cpp:1-5, data_loader.cc:87-109); here the descriptor is a soft
VLAD aggregation over the keyframe's own SuperPoint descriptors:

  a_kc = softmax_c(alpha * d_k . c_c)           soft cluster assignment
  V_c  = sum_k valid_k a_kc (d_k - r*c_c)       aggregation (r = residual)
  V_c <- V_c / ||V_c||                          intra-normalization
  v    = flatten(V) / ||flatten(V)||            (C*D,)
  out  = (v - mean) P / ||(v - mean) P||        projection to out_dim

`init_params` and `load_params` are numpy copies of the JAX package's (the
seeded projection is rebuilt with numpy, so both packages hold the same
256 MiB matrix); `NetVLAD` keeps the centroids, projection and mean as
buffers on its device and aggregates there in full float32 (no TF32).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from sp_orb_slam_tpu_torch.utils.precision import full_f32


def init_params(seed: int = 0, *, n_clusters: int = 64, desc_dim: int = 256,
                out_dim: int = 4096, alpha: float = 80.0) -> Dict[str, Any]:
    """Seeded random centroids (unit norm) + a random orthonormal-column
    projection (C*D, out_dim).  Random init uses r = 0 (soft sum-pooling):
    with random centroids the residual term makes every frame's cluster
    residual point at -c and all frames correlate."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(0, 1, (n_clusters, desc_dim)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    # Gaussian columns scaled by 1/sqrt(C*D) preserve dot products in
    # expectation (Johnson-Lindenstrauss), which is all the scorer reads
    proj = rng.normal(0, 1.0 / np.sqrt(n_clusters * desc_dim),
                      (n_clusters * desc_dim, out_dim)).astype(np.float32)
    return {"centroids": cent, "proj": proj,
            "alpha": np.float32(alpha), "residual": np.float32(0.0),
            "mean": np.zeros(n_clusters * desc_dim, np.float32)}


def load_params(path: str) -> Dict[str, Any]:
    """Trained weights from an .npz with centroids/proj/alpha and the
    optional centering mean.  Checkpoints may store `proj_seed` + `out_dim`
    in place of the 256 MiB projection, which `init_params` rebuilds."""
    z = np.load(path)
    cent = z["centroids"].astype(np.float32)
    if "proj" in z.files:
        proj = z["proj"].astype(np.float32)
    else:
        C, D = cent.shape
        proj = init_params(int(z["proj_seed"]), n_clusters=C, desc_dim=D,
                           out_dim=int(z["out_dim"]))["proj"]
    p = {"centroids": cent, "proj": proj,
         "alpha": (np.float32(z["alpha"]) if "alpha" in z.files
                   else np.float32(80.0)),
         "residual": (np.float32(z["residual"]) if "residual" in z.files
                      else np.float32(1.0))}
    p["mean"] = (z["mean"].astype(np.float32) if "mean" in z.files
                 else np.zeros(proj.shape[0], np.float32))
    return p


class NetVLAD(nn.Module):
    """(..., K, 256) unit descriptors + (..., K) validity -> (..., out_dim)
    unit global descriptors, on `device` (the card unless the caller
    passes "cpu")."""

    def __init__(self, params: Dict[str, Any],
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to compute NetVLAD on the CPU")
        for name in ("centroids", "proj", "mean"):
            self.register_buffer(
                name, torch.from_numpy(np.asarray(params[name],
                                                  np.float32)).to(dev))
        self.alpha = float(params["alpha"])
        self.residual = float(params["residual"])

    def forward(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        with full_f32():
            v = aggregate(desc, valid, self.centroids, self.alpha,
                          self.residual)
            out = (v - self.mean) @ self.proj
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def aggregate(desc: torch.Tensor, valid: torch.Tensor, cent: torch.Tensor,
              alpha: float, residual: float) -> torch.Tensor:
    """(..., K, D) descriptors + (..., K) validity -> (..., C*D) unit VLAD
    vectors before the projection (the module docstring's first four
    lines), in the caller's precision."""
    logits = alpha * (desc @ cent.T)                             # (..., K, C)
    assign = torch.softmax(logits, -1) * valid[..., None].to(logits.dtype)
    vlad = (assign.transpose(-1, -2) @ desc
            - residual * assign.sum(-2)[..., None] * cent)
    vlad = vlad / vlad.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    v = vlad.flatten(-2)
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
