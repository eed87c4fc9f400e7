"""The port's batch evaluation (sp_orb_slam_tpu_torch/eval/batch.py and the
`python -m sp_orb_slam_tpu_torch.evaluate` command) on the CPU: the five
tests of tests/test_eval_batch.py against the port with device="cpu",
plus the command's argument parsing and its default on the card."""

import os

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu_torch import evaluate as cli
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval import batch

torch.set_num_threads(2)


def small_cfg():
    return _merge_dataclass(Config(), {
        "dataset": "synthetic",
        "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                   "cx": 160.0, "cy": 120.0, "fps": 20.0},
        "tracking": {"num_features": 250},
        "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                    "local_points_cap": 1024, "ba_kfs_cap": 32,
                    "ba_points_cap": 1024, "ba_obs_cap": 4096,
                    "init_ransac_iters": 60},
    })


def test_load_tum_trajectory(tmp_path):
    p = tmp_path / "gt.txt"
    p.write_text("# comment\n"
                 "0.0 1.0 2.0 3.0 0 0 0 1\n"
                 "0.05 1.1 2.1 3.1 0 0 0 1\n")
    ts, pos = batch.load_tum_trajectory(str(p))
    np.testing.assert_allclose(ts, [0.0, 0.05])
    np.testing.assert_allclose(pos, [[1, 2, 3], [1.1, 2.1, 3.1]])


def test_load_euroc_gt_csv(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("#timestamp,px,py,pz,qw,qx,qy,qz\n"
                 "1403636580838555648,4.68,-1.78,0.80,0.53,-0.15,-0.82,-0.08\n")
    ts, pos = batch.load_euroc_gt_csv(str(p))
    assert abs(ts[0] - 1403636580.838555648) < 1e-4
    np.testing.assert_allclose(pos[0], [4.68, -1.78, 0.80])


def test_tsukuba_gt_lookup(tmp_path):
    (tmp_path / "lamps" / "left").mkdir(parents=True)
    (tmp_path / "gt.txt").write_text("0.0 0 0 0 0 0 0 1\n"
                                     "0.05 0.1 0 0 0 0 0 1\n")
    from sp_orb_slam_tpu_torch.io.dataset import TsukubaDataset

    ds = TsukubaDataset(str(tmp_path / "lamps"))
    ts, pos = ds.gt_trajectory()
    assert len(ts) == 2 and pos[1][0] == 0.1
    # the protocol's own lookup finds the same file
    cfg = _merge_dataclass(Config(), {"dataset": "tsukuba",
                                      "data_path": str(tmp_path)})
    ts2, pos2 = batch._gt_for(cfg, "lamps", object())
    np.testing.assert_array_equal(pos2, pos)


def test_evaluate_protocol(tmp_path):
    """Two runs on the synthetic rail: per-run APE, reference-format
    summary, per-run trajectory files, results.json."""
    out = batch.evaluate(small_cfg(), ["1"], runs=2, out_dir=str(tmp_path),
                         max_frames=50, device="cpu")
    assert out["sequences"]["1"]["runs"] == 2
    s = out["sequences"]["1"]
    assert s["failures"] + sum(
        0 if r["failed"] else 1 for r in out["all_runs"]) == 2
    if s["failures"] < 2:
        assert np.isfinite(s["rmse"])
    assert os.path.exists(tmp_path / "1" / "1.txt")
    assert os.path.exists(tmp_path / "1" / "2.txt")
    assert os.path.exists(tmp_path / "kf" / "1" / "1.txt")
    assert os.path.exists(tmp_path / "results.json")


def test_failure_counting():
    """A run whose APE exceeds the threshold is counted failed, not
    averaged (evo_euroc.py:56-58)."""
    cfg = _merge_dataclass(small_cfg(), {"eval_failure_threshold": 1e-9})
    out = batch.evaluate(cfg, ["1"], runs=1, max_frames=50, device="cpu")
    assert out["sequences"]["1"]["failures"] == 1
    assert np.isnan(out["sequences"]["1"]["rmse"])


def test_evaluate_arguments():
    """The JAX package's flags plus --device, which defaults to the card;
    image datasets need weights."""
    a = cli.parse_args([])
    assert (a.dataset, a.runs, a.device, a.seqs, a.out) == (
        "synthetic", 5, "cuda", "", None)
    a = cli.parse_args(["--dataset", "tsukuba", "--data-path", "/d",
                        "--model-path", "w.npz", "--seqs", "lamps,daylight",
                        "--runs", "3", "--max-frames", "40", "--out", "o",
                        "--online", "--loop", "--device", "cpu"])
    assert (a.dataset, a.data_path, a.model_path, a.seqs, a.runs,
            a.max_frames, a.out, a.online, a.loop, a.device) == (
        "tsukuba", "/d", "w.npz", "lamps,daylight", 3, 40, "o", True, True,
        "cpu")
    with pytest.raises(SystemExit):
        cli.main(["--dataset", "euroc", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--runs", "1", "--seqs", "1", "--max-frames", "2"])
