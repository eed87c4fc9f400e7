"""The plain reference of the frontend step, in plain PyTorch.

It imports nothing of the program (`sp_orb_slam_tpu_torch`), of the JAX
package or of JAX.  It takes the frames and the checkpoint that the
benchmark hands it and works everything out again: the conv stack and the
heads (`superpoint`), the grid NMS and the selection (`nms`), the
covariance fill (`covariance`), the descriptor sampling (`descriptors`)
and the initialisation matcher (`matching`).  `extract` runs them in that
order over a block of frames.
"""

from __future__ import annotations

import torch

from portbench.reference import covariance, descriptors, nms, superpoint


def weights_on(state: dict, device) -> dict:
    """The checkpoint's numpy arrays as float32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in state.items()}


def maps(images: torch.Tensor, weights: dict, cfg: dict,
         precision: str = "float32") -> superpoint.Maps:
    logits, desc = superpoint.forward(images, weights, precision)
    return superpoint.head(logits, desc, cfg["conf_thresh"])


def extract(images: torch.Tensor, weights: dict, cfg: dict,
            precision: str = "float32") -> dict:
    """images (N, H, W) float32 in [0, 1] -> the frontend's outputs for the
    configuration `cfg`: the dense maps (`maps`), the keypoints (uv,
    score, valid, occ_grid, count), their descriptors, covariance and
    response."""
    m = maps(images, weights, cfg, precision)
    alive = nms.grid_nms(m.score, m.cand_uv, m.cand_valid,
                         dist=cfg["nms_dist"], iters=cfg["nms_iters"])
    kp = nms.select(m.score, m.cand_uv, alive,
                    num_features=cfg["num_features"],
                    max_keypoints=cfg["max_keypoints"], border=cfg["border"])
    desc = descriptors.sample(m.unit_desc, kp.uv, kp.valid)
    cov2, response = covariance.covariance(
        m.heat_inv, kp.uv, kp.valid, radius=cfg["cov_window"],
        iters=cfg["cov_iters"])
    return dict(maps=m, uv=kp.uv, score=kp.score, valid=kp.valid,
                occ_grid=kp.occ_grid, count=kp.count, desc=desc, cov2=cov2,
                response=response)
