"""The port's warmup (System.warmup, StreamFleet.warmup,
TrackingKernels.warmup, LoopClosing.warmup) against what a run calls.

The JAX package's tests/test_warmup.py counts XLA compile variants, which
have no counterpart here.  These tests spy on the stage methods of
TrackingKernels instead (chip_smoke.spy_stages, which phases 9 and 10 apply
on the card): after warmup, a synthetic run calls no stage (nor stage
variant: fused and local-map windows, unbatched and vmapped mapper
batches) that warmup did not call; under the heat coarse tracker the heat
stage takes the dust stages' place in warmup and in the run.
"""

import importlib.util
import os

import pytest
import torch

from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import tracking as tr
from sp_orb_slam_tpu_torch.slam.system import System

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spy_stages(kernels):
    """chip_smoke.py's spy: the stage variants called, counted."""
    return _chip_smoke().spy_stages(kernels)


def _cfg(**over):
    base = {
        "dataset": "synthetic",
        "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                   "cx": 160.0, "cy": 120.0, "fps": 20.0},
        "tracking": {"num_features": 250},
        "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                    "local_points_cap": 1024, "ba_kfs_cap": 32,
                    "ba_points_cap": 1024, "ba_obs_cap": 4096,
                    "init_ransac_iters": 60},
    }
    base.update(over)
    return _merge_dataclass(Config(), base)


@pytest.mark.parametrize("online", [False, True])
def test_system_warmup_covers_a_run(online):
    """After System.warmup, a 40-frame synthetic spin (offline, and online
    with the mapping thread) calls only stages warmup called."""
    cfg = _cfg(online=online)
    ds = SyntheticDataset(cfg, n_frames=40, n_points=5000, seed=6,
                          pixel_noise=0.3)
    sys_ = System(cfg, device="cpu")
    seen = spy_stages(sys_.kernels)
    sys_.warmup()
    warmed = set(seen)
    seen.clear()
    sys_.spin(ds)
    rep = sys_.report()
    assert sys_.tracker.state == tr.OK, rep
    assert seen, "the spin called no stage"
    assert not set(seen) - warmed, set(seen) - warmed


def test_fleet_warmup_covers_ticks():
    """After StreamFleet.warmup, 30 ticks of two synthetic streams call
    only stages warmup called."""
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = _cfg()
    streams = [list(SyntheticDataset(cfg, n_frames=30, n_points=5000,
                                     seed=s, pixel_noise=0.3))
               for s in (3, 4)]
    fleet = StreamFleet(cfg, 2, params=None, device="cpu")
    seen = spy_stages(fleet.kernels)
    fleet.warmup()
    warmed = set(seen)
    seen.clear()
    for k in range(30):
        fleet.tick([streams[0][k], streams[1][k]])
    fleet.shutdown()
    for i, s in enumerate(fleet.systems):
        assert s.tracker.state == tr.OK, (i, s.report())
    assert seen
    assert not set(seen) - warmed, set(seen) - warmed


@pytest.mark.parametrize("entry", ["system", "fleet"])
def test_heat_warmup_covers_a_run(entry):
    """Under coarse_method="heat", warmup runs the heat stage in the dust
    stage's place (and no batched dust stage in the fleet), and a run
    calls only stages warmup called: heat_track, never dust_track,
    dust_track_batch or fused_track."""
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = _cfg(tracking={"num_features": 250, "coarse_method": "heat"})
    streams = [list(SyntheticDataset(cfg, n_frames=30, n_points=5000,
                                     seed=s, pixel_noise=0.3))
               for s in ((6,) if entry == "system" else (3, 4))]
    if entry == "system":
        runner = System(cfg, device="cpu")
        kernels, systems = runner.kernels, [runner]
    else:
        runner = StreamFleet(cfg, 2, params=None, device="cpu")
        kernels, systems = runner.kernels, runner.systems
    seen = spy_stages(kernels)
    runner.warmup()
    warmed = set(seen)
    seen.clear()
    if entry == "system":
        runner.spin(streams[0])
    else:
        for k in range(30):
            runner.tick([st[k] for st in streams])
        runner.shutdown()
    for s in systems:
        assert s.tracker.state == tr.OK, s.report()
    assert ("heat_track", False) in warmed and ("heat_track", False) in seen
    dust = {(n, False) for n in ("dust_track", "dust_track_batch",
                                 "fused_track")}
    assert not dust & (warmed | set(seen)), dict(seen)
    assert not set(seen) - warmed, set(seen) - warmed


def test_loop_warmup_runs_on_the_system_device():
    """LoopClosing.warmup runs on the System's device without touching the
    Sim3 sample stream (the real attempts' draws stay the same)."""
    import torch

    cfg = _merge_dataclass(_cfg(), {"use_loop": True,
                                    "loop": {"use_loop": True}})
    sys_ = System(cfg, device="cpu")
    state = sys_.looper._sim3_gen.get_state().clone()
    sys_.looper.warmup()
    assert torch.equal(sys_.looper._sim3_gen.get_state(), state)
