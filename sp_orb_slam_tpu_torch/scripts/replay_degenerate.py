"""Degenerate-motion (turn-apex, near-zero baseline) replay.

The port of the JAX package's scripts/replay_degenerate.py: the Sim3 ATE of
the whole SLAM path on the synthetic `degenerate` trajectory
(io/dataset.py `_degenerate_trajectory`) for a sweep of seeds, with the
depth filter on and off (reference context: src/cv/depth_filter.cpp:35-60).
It is the measurement behind tests/test_depth_filter.py's replay test.  On
the card the two-view initialization launches the match kernel at B=1.

    python -m sp_orb_slam_tpu_torch.scripts.replay_degenerate \
        [--seeds 0 1 2] [--df on|off|both] [--frames 80] [--device cpu]

Prints the JAX script's line per run and per mode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def replay_config(depth_filter: bool, df_overrides: dict | None = None):
    """The NOTES rail (`accuracy_sweep.rail_config`) with the depth filter
    on or off."""
    from sp_orb_slam_tpu_torch.config import _merge_dataclass
    from sp_orb_slam_tpu_torch.scripts.accuracy_sweep import rail_config

    return _merge_dataclass(rail_config(), {
        "mapping": {"depth_filter": {"enabled": depth_filter,
                                     **(df_overrides or {})}}})


def run_one(seed: int, depth_filter: bool, n_frames: int = 80,
            df_overrides: dict | None = None,
            device: str | torch.device = "cuda") -> dict:
    """One replay: the JAX script's dict (rmse inf under 10 poses; the
    depth filter's counters when it is on)."""
    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = replay_config(depth_filter, df_overrides)
    sys_ = System(cfg, device=device)
    ds = SyntheticDataset(cfg, n_frames=n_frames, n_points=5000, seed=seed,
                          pixel_noise=0.3, trajectory="degenerate")
    sys_.spin(ds)
    rep = sys_.report()
    ts_est, poses_est = sys_.trajectory()
    ts_gt, poses_gt = ds.gt_trajectory()
    out = dict(seed=seed, df=depth_filter, rmse=float("inf"),
               n_lost=rep["n_lost"], n_kf=rep["n_keyframes"],
               n_pts=rep["n_points"], n_est=len(ts_est))
    if len(ts_est) < 10:
        return out
    out["rmse"] = float(ate_sim3(ts_est, poses_est[:, :3, 3], ts_gt,
                                 poses_gt[:, :3, 3]).rmse)
    f = sys_.mapper.depth_filter
    if f is not None:
        out.update(seeded=f.n_seeded, promoted=f.n_promoted,
                   expired=f.n_expired, updates=f.n_updates,
                   rescued=f.n_rescued)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--df", choices=["on", "off", "both"], default="both")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--rel", type=float, default=None,
                    help="override max_rel_sigma")
    ap.add_argument("--div", type=float, default=None,
                    help="override convergence_div")
    ap.add_argument("--floor", type=int, default=None,
                    help="override min_direct_inserts")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ov = {}
    if args.rel is not None:
        ov["max_rel_sigma"] = args.rel
    if args.div is not None:
        ov["convergence_div"] = args.div
    if args.floor is not None:
        ov["min_direct_inserts"] = args.floor
    modes = {"on": [True], "off": [False], "both": [False, True]}[args.df]
    for df in modes:
        rmses = []
        for seed in args.seeds:
            r = run_one(seed, df, args.frames, ov, device=args.device)
            rmses.append(r["rmse"])
            extra = (f" seeded={r['seeded']} prom={r['promoted']} "
                     f"exp={r['expired']} upd={r['updates']} "
                     f"resc={r['rescued']}" if "seeded" in r else "")
            print(f"df={'on ' if df else 'off'} seed={seed} "
                  f"rmse={r['rmse']:.4f} lost={r['n_lost']} kf={r['n_kf']} "
                  f"pts={r['n_pts']} est={r['n_est']}{extra}", flush=True)
        ok = [x for x in rmses if np.isfinite(x)]
        print(f"df={'on ' if df else 'off'} mean_rmse="
              f"{np.mean(ok) if ok else float('inf'):.4f} "
              f"fail={len(rmses) - len(ok)}/{len(rmses)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
