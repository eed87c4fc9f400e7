"""Place-recognition statistics of the NetVLAD descriptor on the rendered
rail.

The port of the JAX package's scripts/vlad_rendered_stats.py.  It drives
the image path (rendered frames at 752x480 -> trained SuperPoint -> the
seeded random NetVLAD of `netvlad.init_params`, whose numpy draw both
packages share) and reports the similarity structure the loop detector
consumes (loop_closer_vlad.cpp:120-255): revisit pairs must score above
the adjacent-keyframe floor, and distinct viewpoints below it.  On the
card each frame's extraction launches the NMS, covariance and sparse
descriptor kernels at B=1.

    python -m sp_orb_slam_tpu_torch.scripts.vlad_rendered_stats \
        [--weights W.npz] [--stride 10] [--n-frames 300] [--device cpu]

Prints one JSON line with the JAX script's keys.  Deliberate differences:
`--weights` defaults to the committed weights/sp_rendered.npz (the JAX
script's out/sp_rendered.npz is not in the repository), and an empty
revisit or distinct class raises (scripts/_rail.py).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sp_orb_slam_tpu_torch.scripts._rail import (WEIGHTS, frame_descriptors,
                                                 pair_classes)
from sp_orb_slam_tpu_torch.utils.precision import full_f32


def stats(params, *, stride: int = 10, n_frames: int = 300,
          device: str | torch.device = "cuda") -> dict:
    """The JAX script's report for the SuperPoint state dict `params` over
    every `stride`-th of `n_frames` frames of rendered room 0."""
    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models import netvlad

    cfg = Config()
    run = make_extractor(cfg, params, device=device)
    ds = RenderedDataset(cfg, n_frames=n_frames, seed=0, noise_seed=0)
    vlad = netvlad.NetVLAD(
        netvlad.init_params(n_clusters=cfg.loop.netvlad_clusters,
                            out_dim=cfg.loop.global_desc_dim), device=device)
    idxs = list(range(0, n_frames, stride))
    pairs = pair_classes([ds.poses[i] for i in idxs], idxs, stride)
    G = vlad(*frame_descriptors(run, ds, idxs))
    with full_f32():
        S = (G @ G.T).cpu().numpy()

    def q(m):
        return ([round(float(np.quantile(S[m], p)), 3)
                 for p in (0.1, 0.5, 0.9)] if m.any() else None)

    return {
        "n_frames_sampled": len(idxs),
        "revisit_pairs": int(pairs.revisit.sum() // 2),
        "revisit_sim_p10_p50_p90": q(pairs.revisit),
        "distinct_sim_p10_p50_p90": q(pairs.distinct),
        "adjacent_sim_p10_p50_p90": q(pairs.adjacent),
    }


def main(argv=None) -> int:
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=WEIGHTS)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--n-frames", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(stats(load_checkpoint(args.weights), stride=args.stride,
                           n_frames=args.n_frames, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
