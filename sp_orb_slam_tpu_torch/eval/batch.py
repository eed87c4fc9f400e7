"""Batch evaluation: the reference's runs x sequences protocol.

The port of the JAX package's eval/batch.py (orb_ros/scripts/
evaluate_euroc_vo.sh:3-80 with scripts/evo_euroc.py:37-62 and
evo_tsukuba.py:36-59): run the whole system `runs` times on each sequence,
take the Sim3-aligned APE translation mean and RMSE of each run, count a
run as failed when either exceeds `eval_failure_threshold` (1.0 m for
EuRoC, 100 for the centimetre-scale Tsukuba ground truth), and report each
sequence's averages over the runs that did not fail.  Every run's System
runs on `device`, the card unless the caller passes "cpu".
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
from sp_orb_slam_tpu_torch.io.dataset import load_tum_trajectory

EUROC_SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]
TSUKUBA_SEQUENCES = ["daylight", "fluorescent", "lamps", "flashlight"]


def load_euroc_gt_csv(path: str):
    """EuRoC state_groundtruth_estimate0/data.csv -> (ts, positions)
    (evo_euroc.py:40's read_euroc_csv_trajectory)."""
    ts, pos = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(float(row[0]) * 1e-9)
            pos.append([float(row[1]), float(row[2]), float(row[3])])
    return np.asarray(ts), np.asarray(pos)


def _gt_for(cfg: Config, seq: str, dataset):
    """Ground-truth (ts, positions) of a sequence: the dataset's own where
    it has one, else by dataset family."""
    name = cfg.dataset.lower()
    if hasattr(dataset, "gt_trajectory"):
        try:
            ts, poses = dataset.gt_trajectory()
            return ts, poses[:, :3, 3] if poses.ndim == 3 else poses
        except FileNotFoundError:
            pass
    if name.startswith("euroc"):
        return load_euroc_gt_csv(os.path.join(
            cfg.data_path, seq, "mav0", "state_groundtruth_estimate0",
            "data.csv"))
    if name.startswith("tsukuba"):
        # the four illumination variants share one trajectory (gt.txt)
        for p in (os.path.join(cfg.data_path, "gt.txt"),
                  os.path.join(cfg.data_path, seq, "gt.txt")):
            if os.path.exists(p):
                return load_tum_trajectory(p)
        raise FileNotFoundError("tsukuba gt.txt not found under "
                                + cfg.data_path)
    raise ValueError(f"no ground-truth source for dataset {cfg.dataset!r}")


@dataclasses.dataclass
class RunResult:
    seq: str
    run: int
    mean: float
    rmse: float
    failed: bool
    n_frames: int
    n_lost: int
    wall_s: float


def run_once(cfg: Config, seq: str, run_idx: int, params=None,
             out_dir: Optional[str] = None, max_frames: Optional[int] = None,
             device: str | torch.device = "cuda") -> RunResult:
    """One whole-system run on one sequence -> its Sim3 APE (the evo
    protocol), with its TUM and keyframe trajectories under `out_dir`."""
    from sp_orb_slam_tpu_torch.io.dataset import (SyntheticDataset,
                                                  make_dataset)
    from sp_orb_slam_tpu_torch.slam.system import System

    name = cfg.dataset.lower()
    if name.startswith("synthetic"):
        # sequences are seeds; each run perturbs the seed as the
        # reference's nondeterministic re-runs explore the noise
        dataset = SyntheticDataset(cfg, seed=int(seq) * 1000 + run_idx)
    elif name.startswith("rendered"):
        # the sequence is the room's texture seed; runs vary the sensor
        # noise seed
        from sp_orb_slam_tpu_torch.io.render import RenderedDataset

        dataset = RenderedDataset(cfg, seed=int(seq), noise_seed=run_idx)
    else:
        dataset = make_dataset(_merge_dataclass(cfg, {"seq": seq}))
    # the ground truth first: a missing source fails before the long run
    ts_gt, p_gt = _gt_for(cfg, seq, dataset)

    t0 = time.perf_counter()
    sys_ = System(cfg, params=params, device=device)
    sys_.spin(dataset, max_frames=max_frames)
    wall = time.perf_counter() - t0

    ts_est, poses_est = sys_.trajectory()
    rep = sys_.report()
    if len(ts_est) < 10:
        mean = rmse = float("inf")
    else:
        res = ate_sim3(ts_est, poses_est[:, :3, 3], ts_gt, p_gt)
        mean, rmse = float(res.mean), float(res.rmse)
    if out_dir:
        d = os.path.join(out_dir, seq)
        os.makedirs(d, exist_ok=True)
        sys_.save_trajectory_tum(os.path.join(d, f"{run_idx + 1}.txt"))
        kd = os.path.join(out_dir, "kf", seq)
        os.makedirs(kd, exist_ok=True)
        sys_.save_keyframe_trajectory_tum(
            os.path.join(kd, f"{run_idx + 1}.txt"))
    thr = cfg.eval_failure_threshold
    return RunResult(seq=seq, run=run_idx, mean=mean, rmse=rmse,
                     failed=bool(mean > thr or rmse > thr),
                     n_frames=rep["n_frames"], n_lost=rep["n_lost"],
                     wall_s=wall)


def evaluate(cfg: Config, seqs: List[str], runs: int = 5, params=None,
             out_dir: Optional[str] = None, max_frames: Optional[int] = None,
             device: str | torch.device = "cuda") -> dict:
    """The whole protocol.  Prints the reference's per-sequence line
    ('{seq}: mean: M, rmse: R, #failure F', evo_euroc.py:61), writes
    results.json under `out_dir` and returns the results."""
    results: List[RunResult] = []
    table = {}
    for seq in seqs:
        seq_runs = []
        for r in range(runs):
            rr = run_once(cfg, seq, r, params=params, out_dir=out_dir,
                          max_frames=max_frames, device=device)
            results.append(rr)
            seq_runs.append(rr)
            print(f"  {seq} run {r + 1}/{runs}: mean={rr.mean:.4f} "
                  f"rmse={rr.rmse:.4f}{' FAILED' if rr.failed else ''}",
                  flush=True)
        ok = [r for r in seq_runs if not r.failed]
        n_fail = sum(r.failed for r in seq_runs)
        mean = float(np.mean([r.mean for r in ok])) if ok else float("nan")
        rmse = float(np.mean([r.rmse for r in ok])) if ok else float("nan")
        table[seq] = dict(mean=mean, rmse=rmse, failures=n_fail, runs=runs)
        print(f"{seq}: mean: {mean}, rmse: {rmse}, #failure {n_fail}",
              flush=True)
    out = dict(dataset=cfg.dataset, runs=runs, sequences=table,
               all_runs=[dataclasses.asdict(r) for r in results])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            # failed runs carry inf / nan, which strict JSON lacks
            json.dump(_json_sanitize(out), f, indent=1)
    return out


def _json_sanitize(x):
    """Non-finite floats -> None, for standard JSON."""
    if isinstance(x, dict):
        return {k: _json_sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_sanitize(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x
