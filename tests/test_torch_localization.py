"""Localization (tracking-only) mode and the single-shot `run` API of the
port's System, on the CPU, against the JAX package's System on the same
stream (tests/test_localization_mode.py's scenario).

`run` applies the pending toggles before it tracks a frame
(system.cpp:202-233).  Localization mode stops the mapper, so the map
freezes, and tracking goes on; deactivating it resumes mapping.  Both
packages take the same JAX init draws, so the frozen map's keyframe and
point counts agree within test_torch_system.py's 15 %, and every frame of
the localization phase has a pose in both.  A pending reset clears the map
before the next frame, which then starts a new initialization.
"""

import numpy as np
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.system import System
from test_torch_system import SMALL, JaxInitDraws

torch.set_num_threads(2)

SCENE = {"n_frames": 60, "n_points": 5000, "seed": 6, "pixel_noise": 0.3}


def _drive(sys_, frames):
    """Build a map on frames 0-34, localize on 35-49, map again on 50-59;
    returns the counts after the mapping phase and the localization
    phase's poses."""
    for raw in frames[:35]:
        sys_.process(raw)
    before = (sys_.map.n_keyframes(), sys_.map.n_points())
    sys_.activate_localization_mode()
    poses = [sys_.run(raw) for raw in frames[35:50]]
    frozen = (sys_.map.n_keyframes(), sys_.map.n_points())
    assert sys_.tracker.only_tracking and sys_.mapper.stopped
    assert sys_.tracker.state == ttr.OK, sys_.tracker.last_fail
    sys_.deactivate_localization_mode()
    for raw in frames[50:]:
        sys_.run(raw)
    assert not sys_.tracker.only_tracking and not sys_.mapper.stopped
    return before, frozen, poses


def test_localization_mode_matches_jax():
    cfg = _merge_dataclass(Config(), SMALL)
    jcfg = jmerge(JConfig(), SMALL)
    sys_ = System(cfg, device="cpu")
    sys_.tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)
    before, frozen, poses = _drive(sys_, list(SyntheticDataset(cfg, **SCENE)))
    jsys = JSystem(jcfg)
    jbefore, jfrozen, jposes = _drive(jsys, list(JSynthetic(jcfg, **SCENE)))

    assert before[0] >= 5 and frozen == before       # the map froze
    assert sys_.map.n_keyframes() > before[0]        # and grows again
    assert sys_.tracker.state == ttr.OK
    for got, want in zip(before, jbefore):
        assert abs(got - want) <= 0.15 * want, (before, jbefore)
    assert all(p is not None for p in poses)
    assert all(p is not None for p in jposes)
    centres = [np.linalg.inv(p)[:3, 3] for p in poses]
    assert max(np.linalg.norm(a - b)
               for a, b in zip(centres, centres[1:])) > 1e-4


def test_reset_toggle_and_run_frame():
    cfg = _merge_dataclass(Config(), SMALL)
    frames = list(SyntheticDataset(cfg, n_frames=14, seed=2))
    sys_ = System(cfg, device="cpu")
    for raw in frames[:10]:
        sys_.run(raw)
    assert sys_.tracker.state == ttr.OK and sys_.map.n_keyframes() >= 2
    # run_frame tracks a pre-built frame as run tracks a raw one
    pose = sys_.run_frame(sys_._frame_from_injected(frames[10]))
    assert pose is not None and sys_.tracker.state == ttr.OK
    sys_.request_system_reset()
    assert sys_.map.n_keyframes() >= 2          # pending until the next frame
    assert sys_.run(frames[11]) is None         # a new initialization starts
    assert sys_.map.n_keyframes() == 0
    assert sys_.tracker.state == ttr.NOT_INITIALIZED
