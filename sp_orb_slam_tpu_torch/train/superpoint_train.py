"""Train the SuperPoint frontend on procedurally rendered rooms.

The port of the JAX package's train/superpoint_train.py.  The reference's
trained `superpoint.pt` (loaded at sp_extractor.cpp:354-357) is not
available, so the same architecture is trained on the ray-cast rooms of
io/render.py:

- **Detector head**: per-cell 65-way cross-entropy against Harris-corner
  labels (strongest corner pixel per 8x8 cell, dustbin when the cell has
  no corner): MagicPoint-style bootstrap supervision.
- **Descriptor head**: InfoNCE over ground-truth cell correspondences:
  the cell centres of view A are ray-cast into the room and projected into
  view B.
- **Dustbin**: trained by the detector term (cells without corners ->
  class 64), so `dense_dust` is a "no feature here" probability, as the
  dust coarse tracker (tracker_dust.cpp:22-228) reads it.

The reference's matcher and tracker thresholds (TH_LOW=0.3 / TH_HIGH=0.7,
dust association 0.75, sp_matcher.cpp:18-19) are calibrated for trained
descriptors; random weights put every gate in its always-pass regime.

The host part (labels, correspondences, the pool, the batch draws) is
numpy and gives the JAX package's arrays bit for bit.  The model runs in
float32 without TF32 (utils/precision.full_f32, the counterpart of the
JAX package's `Precision.HIGHEST`): its convolutions are cuDNN's through
`F.conv2d` and autograd computes their backward, since the JAX training
forward reaches no Pallas kernel.  Adam with a cosine schedule.

Run (on the card unless `--device cpu`):
    python -m sp_orb_slam_tpu_torch.train.superpoint_train \\
        --steps 3000 --out out/sp_rendered.npz
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint, init_params
from sp_orb_slam_tpu_torch.utils.precision import full_f32


# ---------------------------------------------------------------------------
# labels + correspondences (host-side numpy, cached per rendered image)
# ---------------------------------------------------------------------------


def harris_response(img: np.ndarray, sigma: float = 1.5,
                    k: float = 0.06) -> np.ndarray:
    """Harris corner response on a [0, 255] grayscale image."""
    from scipy.ndimage import gaussian_filter

    I = img.astype(np.float32) / 255.0
    Iy, Ix = np.gradient(I)
    Sxx = gaussian_filter(Ix * Ix, sigma)
    Syy = gaussian_filter(Iy * Iy, sigma)
    Sxy = gaussian_filter(Ix * Iy, sigma)
    return Sxx * Syy - Sxy ** 2 - k * (Sxx + Syy) ** 2


def harris_cell_labels(img: np.ndarray, cell: int = 8,
                       thresh: float = 1e-5) -> np.ndarray:
    """Per-8x8-cell 65-way labels: index of the strongest corner pixel
    (row-major dy*8+dx), or 64 (dustbin) when the cell's best response is
    below `thresh` (1e-5, about the median cell maximum on the rendered
    texture: about half the cells are corner cells).  Border cells are
    dustbin (image-gradient edge artifacts; the extractor drops its border
    too)."""
    H, W = img.shape
    hc, wc = H // cell, W // cell
    R = harris_response(img)[:hc * cell, :wc * cell]
    cells = R.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(
        hc, wc, cell * cell)
    amax = cells.argmax(-1).astype(np.int32)
    vmax = cells.max(-1)
    labels = np.where(vmax > thresh, amax, 64).astype(np.int32)
    labels[0, :] = 64
    labels[-1, :] = 64
    labels[:, 0] = 64
    labels[:, -1] = 64
    return labels


def cell_centers(H: int, W: int, cell: int = 8) -> np.ndarray:
    hc, wc = H // cell, W // cell
    u = cell / 2.0 - 0.5 + cell * np.arange(wc, dtype=np.float32)
    v = cell / 2.0 - 0.5 + cell * np.arange(hc, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    return np.stack([uu.ravel(), vv.ravel()], -1)  # (hc*wc, 2)


def cell_correspondence(ds, Ta: np.ndarray, Tb: np.ndarray,
                        cell: int = 8) -> np.ndarray:
    """GT target cell in view B for each cell of view A (-1 = none).

    Exact: ray-cast A's cell centres into the room (the room is convex, so
    every wall point is visible from any interior pose: no occlusion
    handling), project into B, keep hits whose projection lands within one
    cell diagonal of the target cell centre."""
    H, W = ds.H, ds.W
    hc, wc = H // cell, W // cell
    centers = cell_centers(H, W, cell)
    X, hit = ds.raycast(Ta, centers)
    Tcw_b = np.linalg.inv(Tb.astype(np.float64))
    pc = X @ Tcw_b[:3, :3].T + Tcw_b[:3, 3]
    z = pc[:, 2]
    ok = hit & (z > 0.1)
    u = ds.K[0] * pc[:, 0] / np.where(ok, z, 1.0) + ds.K[2]
    v = ds.K[1] * pc[:, 1] / np.where(ok, z, 1.0) + ds.K[3]
    cu = np.clip(np.round((u - (cell / 2.0 - 0.5)) / cell), 0, wc - 1)
    cv = np.clip(np.round((v - (cell / 2.0 - 0.5)) / cell), 0, hc - 1)
    du = u - (cell / 2.0 - 0.5 + cell * cu)
    dv = v - (cell / 2.0 - 0.5 + cell * cv)
    ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
    ok &= np.hypot(du, dv) <= cell  # within one cell of the target center
    tgt = np.where(ok, (cv * wc + cu).astype(np.int64), -1)
    return tgt.astype(np.int32)  # (hc*wc,)


# ---------------------------------------------------------------------------
# training pool
# ---------------------------------------------------------------------------


def _perturbed_pose(rng: np.random.Generator, Ta: np.ndarray,
                    rot_deg: float = 8.0, trans: float = 0.3) -> np.ndarray:
    ang = np.radians(rng.normal(0, rot_deg, 3))

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        m[i, j] = -s if axis != 1 else s
        m[j, i] = s if axis != 1 else -s
        return m

    dR = rot(ang[0], 0) @ rot(ang[1], 1) @ rot(ang[2], 2)
    dT = np.eye(4)
    dT[:3, :3] = dR
    dT[:3, 3] = rng.normal(0, trans, 3)
    return (Ta @ dT).astype(np.float32)


def build_pool(cfg: Config, n_scenes: int = 4, pairs_per_scene: int = 100,
               seed: int = 0, verbose: bool = True) -> Dict[str, np.ndarray]:
    """Pre-render the training set: image pairs + labels + correspondences."""
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset

    img_a, img_b, lab_a, lab_b, corr = [], [], [], [], []
    t0 = time.time()
    for s in range(n_scenes):
        ds = RenderedDataset(cfg, n_frames=1, seed=seed * 131 + s)
        rng = np.random.default_rng(seed * 997 + s)
        for _ in range(pairs_per_scene):
            Ta = ds.random_pose(rng)
            Tb = _perturbed_pose(rng, Ta)
            ia, ib = ds.render(Ta), ds.render(Tb)
            img_a.append(ia)
            img_b.append(ib)
            lab_a.append(harris_cell_labels(ia))
            lab_b.append(harris_cell_labels(ib))
            corr.append(cell_correspondence(ds, Ta, Tb))
        if verbose:
            print(f"[pool] scene {s + 1}/{n_scenes} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    pool = dict(
        img_a=np.stack(img_a), img_b=np.stack(img_b),
        lab_a=np.stack(lab_a), lab_b=np.stack(lab_b),
        corr=np.stack(corr))
    if verbose:
        n_corner = (pool["lab_a"] != 64).mean()
        n_corr = (pool["corr"] >= 0).mean()
        print(f"[pool] {len(img_a)} pairs; corner cells {n_corner:.0%}, "
              f"corresponding cells {n_corr:.0%}", flush=True)
    return pool


def batches(pool: Dict[str, np.ndarray], batch: int, seed: int = 0,
            noise: float = 2.0) -> Iterator[tuple]:
    """Endless training batches (img_a, img_b, lab_a, lab_b, corr) as numpy,
    drawn from `np.random.default_rng(seed + 17)` in the JAX package's
    order (the pool indices, then noise, gain and offset of img_a, then of
    img_b): the same seed gives the same batches bit for bit."""
    rng = np.random.default_rng(seed + 17)
    n_pool = len(pool["img_a"])

    def prep(imgs, idx):
        x = imgs[idx].astype(np.float32)
        # photometric augmentation: sensor noise + gain/offset
        x = x + rng.normal(0, noise, x.shape)
        gain = rng.uniform(0.8, 1.2, (batch, 1, 1))
        off = rng.uniform(-20, 20, (batch, 1, 1))
        return (np.clip(x * gain + off, 0, 255) / 255.0).astype(np.float32)

    while True:
        idx = rng.integers(0, n_pool, batch)
        img_a = prep(pool["img_a"], idx)
        img_b = prep(pool["img_b"], idx)
        yield (img_a, img_b, pool["lab_a"][idx], pool["lab_b"][idx],
               pool["corr"][idx])


def to_device(arrays, device: torch.device) -> list:
    """numpy arrays -> tensors on `device`; to the card through pinned
    memory without waiting, so the host prepares the next batch while the
    card runs this one."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# losses + optimizer
# ---------------------------------------------------------------------------


def make_loss_fn(tau: float = 0.1, w_desc: float = 1.0):
    """loss_fn(model, img_a, img_b, lab_a, lab_b, corr) -> (loss, (det,
    desc)): the detector's 65-way cross-entropy averaged over all 2B*hc*wc
    cells plus `w_desc` times the InfoNCE of A's cells against all of B's
    at temperature `tau`, averaged over the cells with a correspondence."""

    def loss_fn(model, img_a, img_b, lab_a, lab_b, corr):
        B = img_a.shape[0]
        semi, desc = model.train_forward(torch.cat([img_a, img_b]))
        hc, wc = semi.shape[1], semi.shape[2]
        labels = torch.cat([lab_a, lab_b]).reshape(2 * B, hc, wc).long()
        # class c is in-cell pixel (c // 8, c % 8), 64 the dustbin
        det = F.cross_entropy(semi.permute(0, 3, 1, 2), labels)
        N = hc * wc
        da = desc[:B].reshape(B, N, -1)
        db = desc[B:].reshape(B, N, -1)
        logits = torch.bmm(da, db.transpose(1, 2)) / tau
        corr = corr.reshape(B * N).long()
        valid = (corr >= 0).float()
        ce = F.cross_entropy(logits.reshape(B * N, N), corr.clamp_min(0),
                             reduction="none")
        dl = (ce * valid).sum() / valid.sum().clamp_min(1.0)
        return det + w_desc * dl, (det, dl)

    return loss_fn


def cosine_decay(steps: int, alpha: float = 0.05):
    """The factor on the base rate at update t (from 0):
    optax.cosine_decay_schedule(lr, steps, alpha) / lr."""
    def factor(t: int) -> float:
        return ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(t, steps)
                                                  / steps)) + alpha)
    return factor


def make_train_step(model: SuperPoint, steps: int, lr: float = 1e-3):
    """step(img_a, img_b, lab_a, lab_b, corr) -> (loss, det, desc) tensors:
    one Adam update of `model`'s parameters (optax's `adam`: betas 0.9,
    0.999, eps 1e-8) at the cosine-decayed rate of its update count, the
    forward, backward and update in full float32.  The inputs lie on the
    model's device; the parameters keep their gradients until the next
    step."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))
    loss_fn = make_loss_fn()

    def step(img_a, img_b, lab_a, lab_b, corr):
        opt.zero_grad(set_to_none=True)
        with full_f32():
            loss, (det, dl) = loss_fn(model, img_a, img_b, lab_a, lab_b,
                                      corr)
            loss.backward()
            opt.step()
        sched.step()
        return loss.detach(), det.detach(), dl.detach()

    return step


def train(cfg: Config, pool: Dict[str, np.ndarray], steps: int = 3000,
          batch: int = 8, lr: float = 1e-3, seed: int = 0,
          params: Dict[str, torch.Tensor] | None = None, log_every: int = 50,
          noise: float = 2.0, verbose: bool = True,
          device: str | torch.device = "cuda"):
    """Adam training loop on `device` (the card unless the caller passes
    "cpu"; with no card this raises).  Starts from `params` (a state dict,
    left unchanged) or from `init_params` seeded with `seed`.  Returns the
    trained state dict on the CPU and the history of (step, loss, det,
    desc) at every `log_every`-th step and the last, printed when
    `verbose`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "train on the CPU")
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed))
    model = SuperPoint({k: v.detach().clone() for k, v in params.items()})
    model = model.to(dev).train()
    step = make_train_step(model, steps, lr)
    draws = batches(pool, batch, seed, noise)
    t0 = time.time()
    history: List[tuple] = []
    for it in range(steps):
        loss, det, dl = step(*to_device(next(draws), dev))
        if it % log_every == 0 or it == steps - 1:
            history.append((it, float(loss), float(det), float(dl)))
            if verbose:
                print(f"[train] step {it}: loss {history[-1][1]:.4f} "
                      f"(det {history[-1][2]:.4f} desc {history[-1][3]:.4f}) "
                      f"{time.time() - t0:.1f}s", flush=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return state, history


def camera_config(width: int, height: int, fx: float) -> Config:
    """The default config with a pinhole camera of `width` x `height`,
    focal length `fx` = fy, centred principal point (the command line's
    training camera)."""
    return _merge_dataclass(Config(), {
        "camera": {"width": width, "height": height, "fx": fx, "fy": fx,
                   "cx": width / 2.0, "cy": height / 2.0, "fps": 20.0}})


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--fx", type=float, default=260.0)
    ap.add_argument("--out", default="out/sp_rendered.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless 'cpu'")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to "
                           "train on the CPU")
    cfg = camera_config(args.width, args.height, args.fx)
    pool = build_pool(cfg, n_scenes=args.scenes, pairs_per_scene=args.pairs,
                      seed=args.seed)
    state, _ = train(cfg, pool, steps=args.steps, batch=args.batch,
                     lr=args.lr, seed=args.seed, device=dev)

    from sp_orb_slam_tpu_torch.models import weights

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    weights.save_npz(state, args.out)
    print(f"[train] saved {args.out}", flush=True)


if __name__ == "__main__":
    main()
