"""The port's command line: run the SLAM pipeline over a dataset.

    python -m sp_orb_slam_tpu_torch.run_vo --dataset synthetic [--loop] \
        [--device cpu]
    python -m sp_orb_slam_tpu_torch.run_vo --dataset rendered \
        --weights weights/sp_rendered.npz [--max-frames N]
    python -m sp_orb_slam_tpu_torch.run_vo --config cfg.yaml \
        --data-path DATA --seq MH_05_difficult --weights W.npz
    python -m sp_orb_slam_tpu_torch.run_vo ... --save-map map.npz
    python -m sp_orb_slam_tpu_torch.run_vo ... --load-map map.npz --localization
    python -m sp_orb_slam_tpu_torch.run_vo ... --debug-dir out/viz --live-port 0

Writes traj.txt / kf.txt (TUM format) under --output (default: the
config's output_path where a config sets one, else out/run_vo/ beside the
package), prints the tracking report with the Sim3 ATE against the
dataset's ground truth (where it has one) as one JSON line, and the
timer table on stderr.  The dataset (euroc, tsukuba, an export tree,
synthetic or rendered), `--data-path` and `--seq` override the config's;
the online mode (`online: true`) comes from the YAML config, as in the
JAX package's command line.  Runs on the card unless --device cpu is
given.  `--debug-dir` writes each frame's overlay PNG and periodic map
snapshots (viz/); `--live-port` serves the live viewer (viz/live.py: the
frame overlay, the map, the state and the pause / step / reset /
localization controls) for the run and prints its URL on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def default_output(cfg) -> str:
    """The config's output_path where it differs from the built-in default,
    else out/run_vo/ in the repository holding this package: the built-in
    default is one fixed directory that every copy of the repository (and
    the JAX package's CLI) would share."""
    from sp_orb_slam_tpu_torch.config import Config

    if cfg.output_path != Config.output_path:
        return cfg.output_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "out", "run_vo")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="learned VO/SLAM on PyTorch")
    ap.add_argument("--config", help="YAML config (reference cfg/*.yaml schema)")
    ap.add_argument("--dataset", default=None,
                    help="euroc | tsukuba | *_export | synthetic | rendered "
                         "(overrides the config)")
    ap.add_argument("--data-path", default=None,
                    help="the dataset's root directory")
    ap.add_argument("--seq", default=None,
                    help="the sequence under --data-path (rendered: the "
                         "room's texture seed)")
    ap.add_argument("--weights", default=None,
                    help="SuperPoint checkpoint (.npz/.pt) for image datasets")
    ap.add_argument("--output", default=None,
                    help="trajectory output dir (default: the config's "
                    "output_path where it sets one, else out/run_vo/)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closing (synthetic: a closed-loop "
                         "trajectory)")
    ap.add_argument("--synthetic-frames", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--debug-dir", default=None,
                    help="write per-frame overlay PNGs + map snapshots "
                         "(the offline viewer equivalent)")
    ap.add_argument("--live-port", type=int, default=None,
                    help="serve the live viewer (frame overlay, map, "
                         "pause/step/reset/localization controls) on this "
                         "HTTP port; 0 picks a free port")
    ap.add_argument("--save-map", default=None, metavar="PATH",
                    help="persist the built map (slam/serialize.py) after "
                         "the run")
    ap.add_argument("--load-map", default=None, metavar="PATH",
                    help="start from a saved map (cold-start "
                         "relocalization instead of two-view init)")
    ap.add_argument("--localization", action="store_true",
                    help="tracking-only mode (freeze the map; typically "
                         "with --load-map)")
    args = ap.parse_args(argv)

    from sp_orb_slam_tpu_torch.config import load_config

    overrides = {k: v for k, v in (("dataset", args.dataset),
                                   ("data_path", args.data_path),
                                   ("seq", args.seq),
                                   ("verbose", args.verbose or None))
                 if v is not None}
    if args.loop:
        overrides["use_loop"] = True
    cfg = load_config(args.config, overrides)
    output = args.output or default_output(cfg)

    params = None
    weights = args.weights or cfg.model_path
    if weights:
        from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

        params = load_checkpoint(weights)
    elif not (cfg.dataset == "synthetic"
              or cfg.dataset.lower().endswith("export")):
        raise SystemExit("image datasets need --weights")

    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.dataset import (SyntheticDataset,
                                                  make_dataset)
    from sp_orb_slam_tpu_torch.slam.system import System

    if cfg.dataset == "synthetic":
        dataset = SyntheticDataset(cfg, n_frames=args.synthetic_frames,
                                   loop=args.loop)
    else:
        dataset = make_dataset(cfg)
    system = System(cfg, params=params, device=args.device)
    if args.load_map:
        system.load_map(args.load_map)
    if args.localization:
        system.activate_localization_mode()
    if args.debug_dir:
        system.set_debug_dir(args.debug_dir)
    viewer = None
    if args.live_port is not None:
        from sp_orb_slam_tpu_torch.viz.live import LiveViewer

        viewer = LiveViewer(system, port=args.live_port)
        print(f"live viewer: {viewer.url}", file=sys.stderr)
    try:
        system.spin(dataset, max_frames=args.max_frames)
    finally:
        if viewer is not None:
            viewer.close()
    if args.save_map:
        system.save_map(args.save_map)

    os.makedirs(output, exist_ok=True)
    system.save_trajectory_tum(os.path.join(output, "traj.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(output, "kf.txt"))
    report = system.report()
    ts_est, poses_est = system.trajectory()
    gt = getattr(dataset, "gt_trajectory", None)
    try:
        ts_gt, gt_pose = gt() if gt is not None else (None, None)
    except FileNotFoundError:  # a tree without its ground-truth file
        ts_gt, gt_pose = None, None
    if ts_gt is not None and len(ts_est) >= 3:
        # Twc poses (synthetic, rendered) or positions (gt.txt)
        gt_pos = gt_pose[:, :3, 3] if gt_pose.ndim == 3 else gt_pose
        res = ate_sim3(ts_est, poses_est[:, :3, 3], ts_gt, gt_pos)
        report["ate_rmse"] = res.rmse
        report["ate_mean"] = res.mean
    print(json.dumps(report, default=float))
    print(system.timer.table(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
