"""Validate a trained SuperPoint checkpoint on the rendered image rail.

The port of the JAX package's scripts/validate_weights.py.  The
reference's matcher gates (TH_LOW=0.3 / TH_HIGH=0.7, sp_matcher.cpp:18-19)
are absolute L2 distances between unit descriptors, calibrated for trained
SuperPoint statistics.  This tool measures whether a checkpoint restores
that regime: it extracts two rendered frames (752x480, float32), pairs
keypoints by ray cast (the nearest frame-2 keypoint within 2 px of the
reprojection), reports the matched and random descriptor distances against
TH_LOW / TH_HIGH, and the precision of the init matcher (window 100, ratio
0.9) against geometry: a match is correct within 3 px of the ray cast.
On the card the extraction launches the NMS, covariance and sparse
descriptor kernels at B=2 and the matcher the match kernel at B=1.

    python -m sp_orb_slam_tpu_torch.scripts.validate_weights \
        [--weights W.npz | random] [--frames 0,2] [--seed 0] [--device cpu]

Prints one JSON line with the JAX script's keys.  Deliberate differences:
`--weights` defaults to the committed weights/sp_rendered.npz (the JAX
script's out/sp_rendered.npz is not in the repository), and `--weights
random` draws the port's own `superpoint.init_params` (generator seed 0),
not JAX's `jax.random` draw.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sp_orb_slam_tpu_torch.scripts._rail import WEIGHTS


def project(Twc, K, X):
    """World points (N, 3) -> pixel uv (N, 2) and a z > 0.1 mask, through
    Tcw = inv(Twc)."""
    R = Twc[:3, :3]
    t = Twc[:3, 3]
    Xc = (X - t[None, :]) @ R  # R^T (X - t)
    z = Xc[:, 2]
    u = K[0] * Xc[:, 0] / z + K[2]
    v = K[1] * Xc[:, 1] / z + K[3]
    return np.stack([u, v], -1), z > 0.1


def load_weights(weights: str):
    """The checkpoint's state dict, or a seeded random one for "random"."""
    from sp_orb_slam_tpu_torch.models import superpoint
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    if weights == "random":
        return superpoint.init_params(torch.Generator().manual_seed(0))
    return load_checkpoint(weights)


def validate(params, *, frames=(0, 2), seed: int = 0,
             device: str | torch.device = "cuda") -> dict:
    """The report of the JAX script (without its "weights" key) for the
    state dict `params` on frames `frames` of rendered room `seed`."""
    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.ops import cuda_match

    cfg = Config()
    run = make_extractor(cfg, params, device=device)
    ds = RenderedDataset(cfg, seed=seed, noise_seed=0)
    fa, fb = (ds.frame(int(i)) for i in frames)
    feats = run(np.stack([fa.image, fb.image]).astype(np.float32) / 255.0)
    uv = feats.uv.cpu().numpy()
    desc = feats.desc.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    na, nb = int(valid[0].sum()), int(valid[1].sum())

    # ground-truth pairs: ray-cast A's keypoints, project into B, take the
    # nearest B keypoint under 2 px
    X, hit = ds.raycast(fa.gt_pose, uv[0][valid[0]])
    uvb_gt, infront = project(fb.gt_pose, ds.K, X)
    d2 = np.linalg.norm(uvb_gt[:, None, :] - uv[1][valid[1]][None, :, :],
                        axis=-1)
    jbest = d2.argmin(1)
    dbest = d2.min(1)
    gt_ok = hit & infront & (dbest < 2.0)
    da = desc[0][valid[0]][gt_ok]
    db = desc[1][valid[1]][jbest[gt_ok]]
    matched = np.linalg.norm(da - db, axis=-1)

    rng = np.random.default_rng(0)
    ra = desc[0][valid[0]][rng.integers(0, na, 4000)]
    rb = desc[1][valid[1]][rng.integers(0, nb, 4000)]
    random_d = np.linalg.norm(ra - rb, axis=-1)

    # the init matcher (search_for_initialization) against geometry
    m12, _, _ = cuda_match.match_init_batch(
        feats.desc[:1], feats.valid[:1], feats.uv[:1], feats.desc[1:],
        feats.uv[1:], feats.valid[1:], window=100, ratio=0.9)
    midx = m12[0].cpu().numpy()  # per-A-keypoint B index or -1
    sel = midx >= 0
    Xall, hitall = ds.raycast(fa.gt_pose, uv[0])
    uvb_all, infront_all = project(fb.gt_pose, ds.K, Xall)
    reproj_err = np.linalg.norm(uvb_all - uv[1][np.maximum(midx, 0)],
                                axis=-1)
    correct = sel & hitall & infront_all & (reproj_err < 3.0)

    def q(a):
        return ([round(float(np.quantile(a, p)), 4) for p in (0.1, 0.5, 0.9)]
                if len(a) else None)

    return {
        "n_kp": [na, nb],
        "n_gt_pairs": int(gt_ok.sum()),
        "matched_l2_p10_p50_p90": q(matched),
        "random_l2_p10_p50_p90": q(random_d),
        "separation_p50": (round(float(np.median(random_d)
                                       / max(np.median(matched), 1e-9)), 2)
                           if len(matched) else None),
        "gt_under_TH_LOW": (round(float((matched <= 0.3).mean()), 3)
                            if len(matched) else None),
        "gt_under_TH_HIGH": (round(float((matched <= 0.7).mean()), 3)
                             if len(matched) else None),
        "random_under_TH_HIGH": round(float((random_d <= 0.7).mean()), 3),
        "init_matches": int(sel.sum()),
        "init_precision": round(float(correct.sum() / max(sel.sum(), 1)), 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=WEIGHTS,
                    help="a SuperPoint .npz checkpoint, or 'random'")
    ap.add_argument("--frames", default="0,2",
                    help="two frame indices of the rendered loop sequence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    frames = tuple(int(x) for x in args.frames.split(","))
    out = {"weights": args.weights,
           **validate(load_weights(args.weights), frames=frames,
                      seed=args.seed, device=args.device)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
