"""The port's synthetic-rail tools (sp_orb_slam_tpu_torch/scripts/) against
the JAX package's scripts/, on the CPU.

The port's tracker takes the JAX package's two-view RANSAC draws
(tests/test_torch_system.py `JaxInitDraws`), as the System parity tests do:
- replay_degenerate `run_one`, seed 1 with the depth filter on, 40 frames:
  equal LOST counts, the Sim3 ATE within 0.02, the same depth-filter
  counters reported;
- accuracy_sweep, seed 1, 40 frames, no warmup: the JAX script's summary
  keys and row keys, equal LOST and failure counts, the ATE within 0.02,
  keyframes within 15 %.
"""

import json
import sys

import torch

from sp_orb_slam_tpu_torch.scripts import accuracy_sweep as tsweep
from sp_orb_slam_tpu_torch.scripts import replay_degenerate as treplay
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from test_torch_scripts_vlad import _jax_script
from test_torch_system import JaxInitDraws

torch.set_num_threads(2)

FRAMES = 40


def use_jax_draws(monkeypatch):
    """The port's trackers draw the JAX package's init samples from here on
    (one stream: each test makes one port System)."""
    draws = JaxInitDraws(60)  # the rail's runtime.init_ransac_iters
    monkeypatch.setattr(ttr.Tracking, "_init_draws",
                        lambda self, n: draws(n))


def test_replay_run_one_matches_jax(monkeypatch):
    use_jax_draws(monkeypatch)
    want = _jax_script("replay_degenerate").run_one(1, True, FRAMES)
    got = treplay.run_one(1, True, FRAMES, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["n_lost"] == want["n_lost"]
    assert got["rmse"] < 0.1 and abs(got["rmse"] - want["rmse"]) < 0.02, (
        got, want)


def test_accuracy_sweep_matches_jax(monkeypatch, capsys):
    argv = ["--seeds", "1", "--frames", str(FRAMES), "--no-warmup"]
    monkeypatch.setattr(sys, "argv", ["tpu_accuracy_sweep.py", *argv])
    capsys.readouterr()
    _jax_script("tpu_accuracy_sweep").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    use_jax_draws(monkeypatch)
    tsweep.main([*argv, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    assert (got["backend"], want["backend"]) == ("cpu", "cpu")
    for k in ("n_seeds", "warmup", "n_lost_total", "n_failed",
              "n_tail_violations"):
        assert got[k] == want[k], k
    (g,), (w,) = got["rows"], want["rows"]
    assert sorted(g) == sorted(w)
    for k in ("seed", "n_lost", "ok"):
        assert g[k] == w[k], k
    for k in ("ate_rmse", "ate_mean"):
        assert g[k] < 0.1 and abs(g[k] - w[k]) < 0.02, (k, g, w)
    assert abs(g["n_kfs"] - w["n_kfs"]) <= 0.15 * w["n_kfs"], (g, w)
