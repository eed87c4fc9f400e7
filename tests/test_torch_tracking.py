"""The tracker's recovery paths against the JAX package, on the CPU: the
synthetic rail of test_torch_system.py with a few blacked-out frames (no
features), run through the JAX package's System and the port's
System(device="cpu") with the JAX package's two-view draws.

- A blackout after the map has > 5 keyframes makes those frames LOST and
  the next frames relocalize (Tracking._relocalize: multi-start
  reference-KF matching against recent keyframes).
- A blackout while the map has <= 5 keyframes makes the tracker request a
  reset (tracker.cpp:329-335): System.reset clears the map and the
  two-view init starts again.

Both Systems must lose the same frames and end OK; the port's ATE must be
within 0.02 of the JAX package's, and its keyframe and point counts within
15 %."""

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io import dataset as jds
from sp_orb_slam_tpu.slam import tracking as jtr
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
from sp_orb_slam_tpu_torch.io import dataset as tds
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.system import System

from test_torch_system import SMALL, JaxInitDraws

torch.set_num_threads(2)


def _blacked_out(ds, lo, hi):
    frames = []
    for i in range(ds.n_frames):
        raw = ds.frame(i)
        if lo <= i < hi:  # no features at all
            inj = raw.injected
            inj["valid"][:] = False
            inj["uv"][:] = 0
            inj["occ_grid"][:] = -1
            inj["count"] = 0
        frames.append(raw)
    return frames


class _Counted(System):
    """The port's System, counting resets and relocalizations, with the
    JAX package's init draws re-armed on every new tracker."""

    def __init__(self, cfg):
        super().__init__(cfg, device="cpu")
        self.resets = 0
        self.relocs = 0
        self._arm()

    def _arm(self):
        tr = self.tracker
        tr._init_draws = JaxInitDraws(self.cfg.runtime.init_ransac_iters)
        reloc = tr._relocalize

        def counted(frame):
            self.relocs += 1
            return reloc(frame)

        tr._relocalize = counted

    def reset(self):
        super().reset()
        self.resets += 1
        self._arm()


@pytest.mark.parametrize("lo,hi,path", [(30, 33, "relocalize"),
                                        (8, 10, "reset")])
def test_recovery_matches_jax(lo, hi, path):
    jcfg, cfg = jmerge(JConfig(), SMALL), _merge_dataclass(Config(), SMALL)
    kw = dict(n_frames=50, n_points=5000, seed=6, pixel_noise=0.3)
    jsys = JSystem(jcfg)
    jsys.spin(_blacked_out(jds.SyntheticDataset(jcfg, **kw), lo, hi))
    ds = tds.SyntheticDataset(cfg, **kw)
    tsys = _Counted(cfg)
    tsys.spin(_blacked_out(ds, lo, hi))

    jrep, trep = jsys.report(), tsys.report()
    assert jsys.tracker.state == jtr.OK and tsys.tracker.state == ttr.OK
    assert trep["n_lost"] == jrep["n_lost"] >= 1, (trep, jrep)
    assert trep["n_frames"] == jrep["n_frames"]
    if path == "relocalize":
        assert tsys.relocs >= 1 and tsys.resets == 0
        assert trep["n_lost"] == hi - lo   # recovered on the next frame
    else:
        assert tsys.resets == 1
    tg, pg = ds.gt_trajectory()
    ates = []
    for s in (jsys, tsys):
        ts, poses = s.trajectory()
        ates.append(ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3]).rmse)
    assert abs(ates[1] - ates[0]) < 0.02, ates
    for k in ("n_keyframes", "n_points"):
        assert abs(trep[k] - jrep[k]) <= 0.15 * jrep[k], (k, trep, jrep)
    assert np.isfinite(ates[1])
