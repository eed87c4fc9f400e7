"""The port's batch evaluation command: the reference's
evaluate_{euroc,tsukuba}_vo.sh protocol (runs x sequences, Sim3 APE mean
and RMSE, failure counting) as one command, on the card unless --device
cpu is given.

    python -m sp_orb_slam_tpu_torch.evaluate --dataset synthetic --runs 5 \
        --seqs 1,2,3 [--device cpu]
    python -m sp_orb_slam_tpu_torch.evaluate --dataset euroc \
        --data-path DATA --model-path W.npz --runs 5
    python -m sp_orb_slam_tpu_torch.evaluate --dataset tsukuba \
        --data-path DATA --model-path W.npz --seqs lamps --runs 5

Writes each run's TUM trajectory (<out>/<seq>/<run>.txt), its keyframe
trajectory (<out>/kf/<seq>/<run>.txt) and <out>/results.json, and prints
the reference's per-sequence lines; --out defaults to out/evaluate/ in the
repository holding this package.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="batch evaluation on PyTorch")
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic | rendered | euroc | tsukuba | export")
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closing (computed place-recognition "
                         "descriptors)")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--model-path", default="",
                    help="SuperPoint weights (.npz); required for image "
                         "datasets")
    ap.add_argument("--config", default="", help="YAML config overrides")
    ap.add_argument("--seqs", default="",
                    help="comma-separated; defaults to the full benchmark "
                         "set (11 EuRoC / 4 Tsukuba / seeds 1-3 synthetic / "
                         "held-out rooms 4-6 rendered)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="output dir for the per-run trajectories and "
                         "results.json (default: out/evaluate/)")
    ap.add_argument("--online", action="store_true",
                    help="the threaded mode (the reference protocol runs "
                         "online; offline is the deterministic baseline)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from sp_orb_slam_tpu_torch.config import (Config, _merge_dataclass,
                                              load_config)
    from sp_orb_slam_tpu_torch.eval import batch

    cfg = load_config(args.config) if args.config else Config()
    overrides = {"dataset": args.dataset, "data_path": args.data_path,
                 "online": bool(args.online)}
    if args.loop:
        overrides["use_loop"] = True
        overrides["loop"] = {"use_loop": True, "global_desc_source": "vlad"}
    if args.dataset.startswith("tsukuba"):
        overrides["eval_failure_threshold"] = 100.0  # centimetre-scale GT
        overrides["camera"] = {"width": 640, "height": 480, "fx": 615.0,
                               "fy": 615.0, "cx": 320.0, "cy": 240.0}
    cfg = _merge_dataclass(cfg, overrides)

    if args.seqs:
        seqs = args.seqs.split(",")
    elif args.dataset.startswith("euroc"):
        seqs = batch.EUROC_SEQUENCES
    elif args.dataset.startswith("tsukuba"):
        seqs = batch.TSUKUBA_SEQUENCES
    elif args.dataset.startswith("rendered"):
        # held-out rooms: the trained weights saw texture seeds 0-3
        seqs = ["4", "5", "6"]
    else:
        seqs = ["1", "2", "3"]

    params = None
    if args.model_path:
        from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

        params = load_checkpoint(args.model_path)
    elif not args.dataset.startswith(("synthetic", "export")):
        raise SystemExit("--model-path required for image datasets")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = args.out or os.path.join(root, "out", "evaluate")
    out = batch.evaluate(cfg, seqs, runs=args.runs, params=params,
                         out_dir=out_dir, max_frames=args.max_frames,
                         device=args.device)
    n_fail = sum(s["failures"] for s in out["sequences"].values())
    print(f"total failures: {n_fail} / {args.runs * len(seqs)} runs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
