"""Fit the loop closer's NetVLAD codebook to a SuperPoint checkpoint.

The port of the JAX package's scripts/fit_vlad_centroids.py.  The VLAD
assignment is a dot-product softmax over unit descriptors, so the clusters
are fitted on the descriptor distribution the extractor produces:

1. extract descriptors from rendered training rooms (texture seeds 0-3,
   the rooms the checkpoint trained on; every `stride`-th of `n_frames`
   frames at the tool's 376x240 camera);
2. spherical k-means over them (cosine assignment, unit centroids), on the
   device in float32 with TF32 off;
3. select alpha, residual and the mode (the seeded random projection
   "rand", the same after subtracting the training mean "cent", or PCA
   whitening fitted on the training frames "white") by the detector-style
   margin on the held-out room (seed 5), with scripts/_rail.py's pair
   classes;
4. save the .npz that `netvlad.load_params` reads (config
   loop.netvlad_weights), in both packages.

    python -m sp_orb_slam_tpu_torch.scripts.fit_vlad_centroids \
        [--weights W.npz] [--out OUT.npz] [--clusters 64] [--device cpu]

Prints one JSON line with the JAX script's keys.  Deliberate differences:
`--out` defaults to out/vlad_rendered.npz beside the package (git-ignored),
so no run overwrites the committed weights/vlad_rendered.npz; the
whitening's SVD runs in float64, so the centred bank's null direction (its
rank is one less than its frame count) never passes the 1e-6 cut on
float32 rounding noise; a singular vector's sign is arbitrary, so a saved
`proj` may differ from the JAX package's by the sign of a column, which
changes no similarity; an empty revisit or distinct class raises
(scripts/_rail.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from sp_orb_slam_tpu_torch.scripts._rail import (REPO, WEIGHTS, Pairs,
                                                 frame_descriptors,
                                                 pair_classes)
from sp_orb_slam_tpu_torch.utils.precision import full_f32

ALPHAS = (40.0, 80.0, 160.0)
RESIDUALS = (0.0, 1.0)


def spherical_kmeans(X: torch.Tensor, C: int, iters: int = 30,
                     seed: int = 0) -> torch.Tensor:
    """Cosine k-means over the unit rows of X (N, D) -> (C, D) unit
    centroids, on X's device.

    The JAX script's loop, batched: each pass assigns every row to its
    nearest centroid and moves every live centroid to its rows' normalised
    sum in one product; a dead cluster is respawned on the worst-fit row,
    as the JAX loop does in cluster order (its centroids below the dead one
    already moved, the rest not yet).  The initial rows are the JAX
    script's draw, `np.random.default_rng(seed).choice`."""
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.choice(len(X), C, replace=False),
                           device=X.device)
    cent = X[rows].clone()
    order = torch.arange(C, device=X.device)[:, None]
    with full_f32():
        for _ in range(iters):
            a = torch.argmax(X @ cent.T, dim=1)
            onehot = torch.nn.functional.one_hot(a, C).to(X.dtype)
            v = onehot.T @ X
            new = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
            dead = (onehot.sum(0) == 0).nonzero().flatten().tolist()
            for c in dead:
                now = torch.where(order < c, new, cent)
                new[c] = X[torch.argmin((X @ now.T).max(dim=1).values)]
            cent = new
    return cent


def raw_vlad(cent: torch.Tensor, alpha: float, residual: float,
             desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, C*D) pre-projection unit VLAD vectors of F frames' descriptors
    (F, K, D) with validity (F, K), in float32 with TF32 off."""
    from sp_orb_slam_tpu_torch.models.netvlad import aggregate

    with full_f32():
        return aggregate(desc, valid, cent, alpha, residual)


def whitening(V: torch.Tensor, out_dim: int) -> tuple:
    """(mean (C*D,), W (C*D, out_dim)) of the training frames' VLADs V: the
    top right singular vectors of the centred V scaled by 1 / s, which
    decorrelates the scene-common structure that inflates every pairwise
    similarity.  Columns past the rank (s <= 1e-6 s[0]) stay zero."""
    mean = V.mean(0)
    _, s, Vt = torch.linalg.svd((V - mean).double(), full_matrices=False)
    k = min(out_dim, int((s > 1e-6 * s[0]).sum()))
    W = torch.zeros((V.shape[1], out_dim), dtype=torch.float32,
                    device=V.device)
    W[:, :k] = (Vt[:k].T / s[:k]).float()
    return mean, W


def project(V: torch.Tensor, mean: torch.Tensor,
            proj: torch.Tensor) -> torch.Tensor:
    """Unit rows of (V - mean) @ proj."""
    with full_f32():
        E = (V - mean) @ proj
    return E / E.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def score(G: torch.Tensor, pairs: Pairs) -> dict:
    """The similarity structure of unit global descriptors G (F, out_dim):
    the loop detector compares dot products with a minScore taken over the
    current covisibles (loop_closer_vlad.cpp:150-165), so report the
    revisit / distinct medians, the adjacent pairs' tenth percentile (the
    candidate bar) and a detector-style margin against it."""
    with full_f32():
        S = (G @ G.T).cpu().numpy()
    r = float(np.median(S[pairs.revisit]))
    d = float(np.median(S[pairs.distinct]))
    a10 = (float(np.quantile(S[pairs.adjacent], 0.1))
           if pairs.adjacent.any() else float("nan"))
    return dict(revisit=round(r, 3), distinct=round(d, 3),
                adjacent_p10=round(a10, 3), margin=round(r - d, 3),
                detector_margin=round(min(r - a10, a10 - d), 3))


def codebook_score(params: dict, desc: torch.Tensor, valid: torch.Tensor,
                   pairs: Pairs) -> dict:
    """`score` of a codebook (netvlad params) on frames (desc, valid)."""
    from sp_orb_slam_tpu_torch.models.netvlad import NetVLAD

    return score(NetVLAD(params, device=desc.device)(desc, valid), pairs)


class Selected(NamedTuple):
    alpha: float
    residual: float
    mode: str
    mean: torch.Tensor
    proj: torch.Tensor


def select(cent: torch.Tensor, bank: tuple, ev: tuple, pairs: Pairs,
           base: dict, out_dim: int) -> tuple:
    """(stats by "a{alpha}_r{residual}_{mode}", the best detector margin,
    its `Selected`) over ALPHAS x RESIDUALS x the three modes; `bank` and
    `ev` are the training and held-out frames' (desc, valid).  The first
    combination with the largest margin wins, as in the JAX script."""
    dev = cent.device
    base_proj = torch.as_tensor(base["proj"], device=dev)
    results, best, best_cfg = {}, None, None
    for alpha in ALPHAS:
        for residual in RESIDUALS:
            Vtr = raw_vlad(cent, alpha, residual, *bank)
            Vev = raw_vlad(cent, alpha, residual, *ev)
            mean, W = whitening(Vtr, out_dim)
            for mode, mean_, proj_ in (
                    ("rand", torch.zeros_like(mean), base_proj),
                    ("cent", mean, base_proj),
                    ("white", mean, W)):
                st = score(project(Vev, mean_, proj_), pairs)
                results[f"a{alpha:g}_r{residual:g}_{mode}"] = st
                if best is None or st["detector_margin"] > best:
                    best = st["detector_margin"]
                    best_cfg = Selected(alpha, residual, mode, mean_, proj_)
    return results, best, best_cfg


def codebook(cent: torch.Tensor, sel: Selected, out_dim: int) -> dict:
    """The .npz's arrays: the whitening matrix is fitted, so it is stored;
    the seeded projection is rebuilt from its seed at load time (256 MB as
    a matrix, 8 bytes as a seed)."""
    save = dict(centroids=cent.cpu().numpy(), mean=sel.mean.cpu().numpy(),
                alpha=np.float32(sel.alpha),
                residual=np.float32(sel.residual))
    if sel.mode == "white":
        save["proj"] = sel.proj.cpu().numpy()
    else:
        save["proj_seed"] = np.int64(0)
        save["out_dim"] = np.int64(out_dim)
    return save


def fit_config(width: int = 376, height: int = 240):
    """Config() with the tool's camera (the JAX script's intrinsics)."""
    from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass

    return _merge_dataclass(Config(), {
        "camera": {"width": width, "height": height,
                   "fx": 178.05, "fy": 209.0, "cx": 181.38, "cy": 125.09}})


class Fit(NamedTuple):
    summary: dict     # the JSON line, less "out"
    save: dict        # the .npz's arrays
    ev: tuple         # the held-out frames' (desc, valid) on the device
    pairs: Pairs      # their pair classes


def fit(params, *, train_seeds=(0, 1, 2, 3), eval_seed: int = 5,
        n_frames: int = 220, stride: int = 8, clusters: int = 64,
        width: int = 376, height: int = 240,
        device: str | torch.device = "cuda") -> Fit:
    """The whole fit for the SuperPoint state dict `params`."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models import netvlad

    cfg = fit_config(width, height)
    run = make_extractor(cfg, params, device=device)
    idxs = list(range(0, n_frames, stride))

    def room(seed):
        ds = RenderedDataset(cfg, n_frames=n_frames, seed=seed, noise_seed=0)
        return ds, frame_descriptors(run, ds, idxs)

    # 1/2: the descriptor bank and spherical k-means
    parts = []
    for s in train_seeds:
        _, part = room(s)
        parts.append(part)
        print(f"seed {s}: {int(part[1].sum())} descriptors", file=sys.stderr)
    bank = tuple(torch.cat(x) for x in zip(*parts))
    X = bank[0][bank[1]]
    print(f"k-means over {len(X)} descriptors", file=sys.stderr)
    cent = spherical_kmeans(X, clusters)

    # 3: alpha / residual / mode on the held-out room
    ds, ev = room(eval_seed)
    pairs = pair_classes([ds.poses[i] for i in idxs], idxs, stride)
    out_dim = cfg.loop.global_desc_dim
    base = netvlad.init_params(n_clusters=clusters, out_dim=out_dim)
    results, best, sel = select(cent, bank, ev, pairs, base, out_dim)
    # the seeded random codebook, for the comparison row
    results["random_init"] = codebook_score(base, *ev, pairs)
    summary = {
        "clusters": clusters, "n_train_desc": int(len(X)),
        "selected": {"alpha": sel.alpha, "residual": sel.residual,
                     "mode": sel.mode},
        "stats": results,
        "selected_detector_margin": best,
        "random_init_detector_margin":
            results["random_init"]["detector_margin"],
    }
    return Fit(summary, codebook(cent, sel, out_dim), ev, pairs)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=WEIGHTS)
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "vlad_rendered.npz"))
    ap.add_argument("--train-seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--eval-seed", type=int, default=5)
    ap.add_argument("--n-frames", type=int, default=220)
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=64)
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    args = parse_args(argv)
    res = fit(load_checkpoint(args.weights), train_seeds=args.train_seeds,
              eval_seed=args.eval_seed, n_frames=args.n_frames,
              stride=args.stride, clusters=args.clusters, width=args.width,
              height=args.height, device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **res.save)
    print(json.dumps({"out": args.out, **res.summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
