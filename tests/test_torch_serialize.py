"""Map save/load and localization in the port (slam/serialize.py), on the
CPU, at test_torch_system.py's small synthetic configuration.

(a) maps cross between the packages both ways: a map saved by the JAX
    package and one saved by the port, each loaded by both packages'
    loaders.  The loaders remap point ids, so the two loads of one file are
    compared: keyframe ids, point ids, poses, positions, descriptors,
    observations and binding tables exactly;
(b) a fresh System localizes against a loaded map in localization mode
    (tests/test_map_serialize.py:115-151): >= 25 frames whose camera
    centre is within 0.05 of the mapping run's, and the map frozen;
(c) the fleet localization server (tests/test_map_serialize.py:82-112): a
    2-stream fleet loads one map and localizes both streams, >= 20 of 30
    ticks with a pose each, the map frozen.
"""

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.slam import serialize as jser
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import serialize as tser
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
from sp_orb_slam_tpu_torch.slam.system import System
from test_torch_system import SMALL

torch.set_num_threads(2)


def _cfg():
    return _merge_dataclass(Config(), SMALL)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """The port's mapping run over 60 synthetic frames: its System,
    the frames, each frame's pose and the saved map."""
    cfg = _cfg()
    ds = list(SyntheticDataset(cfg, n_frames=60, seed=5))
    sys1 = System(cfg, device="cpu")
    poses = {}
    for k, raw in enumerate(ds):
        p = sys1.run(raw)
        if p is not None:
            poses[k] = p
    assert sys1.tracker.state == ttr.OK and sys1.map.n_keyframes() >= 3
    path = str(tmp_path_factory.mktemp("port") / "map.npz")
    sys1.save_map(path)
    return cfg, sys1, ds, poses, path


def _assert_same_map(jw, tw):
    assert sorted(tw.keyframes) == sorted(jw.keyframes)
    assert sorted(tw.points) == sorted(jw.points)
    assert (tw.next_kf_id, tw.kf_origin) == (jw.next_kf_id, jw.kf_origin)
    for name in ("pos", "desc", "desc_track", "normal", "min_dist",
                 "max_dist", "alive"):
        np.testing.assert_array_equal(getattr(tw.pool, name),
                                      getattr(jw.pool, name), err_msg=name)
    for pid, mp in jw.points.items():
        tp = tw.points[pid]
        assert (tp.obs, tp.first_kf, tp.ref_kf, tp.n_visible, tp.n_found) \
            == (mp.obs, mp.first_kf, mp.ref_kf, mp.n_visible, mp.n_found)
    for k, kf in jw.keyframes.items():
        tkf = tw.keyframes[k]
        assert (tkf.frame_id, tkf.timestamp, tkf.parent, tkf.connections,
                tkf.ordered_neighbors, tkf.children, tkf.loop_edges) == (
            kf.frame_id, kf.timestamp, kf.parent, kf.connections,
            kf.ordered_neighbors, kf.children, kf.loop_edges)
        np.testing.assert_array_equal(tkf.Tcw, kf.Tcw)
        np.testing.assert_array_equal(tkf.mp_ids, kf.mp_ids)
        np.testing.assert_array_equal(tkf.data.mp_ids, kf.data.mp_ids)
        for f in ("uv", "valid", "cov2_inv", "occ_grid", "desc_host"):
            np.testing.assert_array_equal(getattr(tkf.data, f),
                                          getattr(kf.data, f), err_msg=f)
        np.testing.assert_array_equal(tkf.data.dust_dev.numpy(),
                                      np.asarray(kf.data.dust_dev))
    assert (tw.n_keyframes(), tw.n_points()) == (jw.n_keyframes(),
                                                 jw.n_points())


def test_jax_saved_map_loads_in_port(tmp_path):
    jcfg = jmerge(JConfig(), SMALL)
    jsys = JSystem(jcfg)
    jsys.spin(JSynthetic(jcfg, n_frames=30, seed=5))
    path = str(tmp_path / "jax_map.npz")
    jsys.save_map(path)
    tw = tser.load_map(path, device="cpu")
    _assert_same_map(jser.load_map(path), tw)
    assert tw.n_keyframes() == jsys.map.n_keyframes() >= 3
    assert tw.n_points() == jsys.map.n_points()
    assert tw.keyframes[0].data.desc_dev.device.type == "cpu"


def test_port_saved_map_loads_in_jax(mapped):
    _, sys1, _, _, path = mapped
    jw = jser.load_map(path)
    _assert_same_map(jw, tser.load_map(path, device="cpu"))
    assert jw.n_keyframes() == sys1.map.n_keyframes()
    assert jw.n_points() == sys1.map.n_points()


def test_load_map_defaults_to_the_card(mapped):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser.load_map(mapped[4])


def test_localize_against_loaded_map(mapped):
    cfg, sys1, ds, poses1, path = mapped
    n_pts, n_kfs = sys1.map.n_points(), sys1.map.n_keyframes()
    sys2 = System(cfg, kernels=sys1.kernels, device="cpu")
    sys2.load_map(path)
    sys2.activate_localization_mode()
    assert sys2.tracker.state == ttr.LOST  # armed for cold relocalization
    matched = 0
    for k in range(20, 55):
        p = sys2.run(ds[k])
        if p is None or k not in poses1:
            continue
        c1 = -poses1[k][:3, :3].T @ poses1[k][:3, 3]
        c2 = -p[:3, :3].T @ p[:3, 3]
        matched += np.linalg.norm(c1 - c2) < 0.05
    assert sys2.tracker.state == ttr.OK, sys2.tracker.last_fail
    assert sys2.tracker.only_tracking
    assert matched >= 25, matched
    assert sys2.map.n_points() == n_pts
    assert sys2.map.n_keyframes() == n_kfs


def test_fleet_localization_server(mapped):
    cfg, sys1, ds, _, path = mapped
    fleet = StreamFleet(cfg, 2, params=None, device="cpu")
    fleet.load_map(path)
    for s in fleet.systems:
        assert s.tracker.state == ttr.LOST  # armed for cold relocalization
    ok_ticks = [0, 0]
    for k in range(20, 50):
        res = fleet.tick([ds[k], ds[min(k + 5, 59)]])
        for i in range(2):
            ok_ticks[i] += res[i] is not None
    fleet.shutdown()
    for i, s in enumerate(fleet.systems):
        assert s.tracker.state == ttr.OK, (i, s.tracker.last_fail)
        assert s.tracker.only_tracking
        assert ok_ticks[i] >= 20, (i, ok_ticks)
        assert s.map.n_keyframes() == sys1.map.n_keyframes()  # frozen
        assert s.map.n_points() == sys1.map.n_points()
