"""The port's online mode (slam/system.py, slam/local_mapping.py,
slam/loop_closing.py, slam/fleet.py) beside the JAX package's.

Mapping (and loop closing) run on their own threads beside tracking with
the stop/accept/interruptBA protocol (local_mapper.cpp:129-229,
system.cpp:92-115).  No gate here depends on the threads' timing: the
keyframe and point counts do (ROADMAP queue 3, R3), so they are not gated.
Every wait has a deadline and fails when it passes.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.eval.ate import ate_sim3 as jate_sim3
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.slam import tracking as jtr
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import local_mapping as lm_mod
from sp_orb_slam_tpu_torch.slam import tracking as tr
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
from sp_orb_slam_tpu_torch.slam.local_mapping import LocalMapping
from sp_orb_slam_tpu_torch.slam.map import Map
from sp_orb_slam_tpu_torch.slam.system import System

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 30.0  # seconds any wait below may take

# tests/test_online_mode.py's configuration
ONLINE_CFG = {
    "dataset": "synthetic", "online": True,
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "fps": 20.0},
    "tracking": {"num_features": 250},
    "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                "local_points_cap": 1024, "ba_kfs_cap": 32,
                "ba_points_cap": 1024, "ba_obs_cap": 4096,
                "init_ransac_iters": 60},
}
RAIL = dict(n_frames=50, n_points=5000, seed=6, pixel_noise=0.3)


def _online_ate_max():
    """The largest ATE of the JAX package's 10-seed online sweep on the
    CPU (CPU_SWEEP_ONLINE_r3b.json: 0.0224)."""
    with open(os.path.join(REPO, "CPU_SWEEP_ONLINE_r3b.json")) as f:
        return json.load(f)["ate_rmse_max"]


def _wait(cond, what, deadline=DEADLINE):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline, f"timed out: {what}"
        time.sleep(1e-3)


def _rail_gates(sys_, ds, report, state_ok):
    """The gates of the synthetic online rail that hold whatever the
    threads' timing; returns the ATE."""
    assert state_ok, report
    assert report["n_lost"] == 0, report
    ts, poses = sys_.trajectory()
    assert len(ts) > 30, len(ts)
    tg, pg = ds.gt_trajectory()
    return ts, poses, tg, pg


@pytest.fixture(scope="module")
def online_runs():
    """The synthetic online rail (50 frames, seed 6) through both
    packages, once."""
    jcfg = jmerge(JConfig(), ONLINE_CFG)
    jds = JSynthetic(jcfg, **RAIL)
    jsys = JSystem(jcfg)
    jsys.spin(jds)
    cfg = _merge_dataclass(Config(), ONLINE_CFG)
    ds = SyntheticDataset(cfg, **RAIL)
    sys_ = System(cfg, device="cpu")
    sys_.spin(ds)
    return {"jax": (jsys, jds), "port": (sys_, ds)}


def test_online_synthetic_rail_port(online_runs):
    """spin starts the mapping thread with the first frame and drains and
    joins it at the end; 0 LOST, > 30 poses, ATE < 0.1 (the JAX test's
    bound)."""
    sys_, ds = online_runs["port"]
    assert sys_.mapper._thread is None and sys_.mapper.error is None
    assert not sys_.mapper.queue
    rep = sys_.report()
    ts, poses, tg, pg = _rail_gates(sys_, ds, rep,
                                    sys_.tracker.state == tr.OK)
    res = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    assert res.rmse < 0.1, res


def test_online_synthetic_rail_agrees_with_jax(online_runs):
    """The JAX package's online rail meets the same gates, and both ATEs
    lie within twice the largest ATE of the JAX package's online seed
    sweep (the factor 2 is headroom for the threads' timing, which moves
    the keyframe set), as does their difference within the sweep's
    largest."""
    jsys, jds = online_runs["jax"]
    assert jsys.mapper._thread is None and not jsys.mapper.queue
    jrep = jsys.report()
    jts, jposes, jtg, jpg = _rail_gates(jsys, jds, jrep,
                                        jsys.tracker.state == jtr.OK)
    jres = jate_sim3(jts, jposes[:, :3, 3], jtg, jpg[:, :3, 3])
    sys_, ds = online_runs["port"]
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    res = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    bound = _online_ate_max()
    assert res.rmse < 2 * bound and jres.rmse < 2 * bound, (res, jres)
    assert abs(res.rmse - jres.rmse) < bound, (res.rmse, jres.rmse)


def _small_cfg():
    return _merge_dataclass(Config(), {
        "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                    "local_points_cap": 1024, "ba_kfs_cap": 32,
                    "ba_points_cap": 1024, "ba_obs_cap": 4096}})


def test_stop_accept_protocol(monkeypatch):
    """RequestStop parks the thread, which then takes nothing from its
    queue however long it idles (here: 50 turns of its wait loop); Release
    resumes it and it drains the queue (local_mapper.h:42-56)."""
    cfg = _small_cfg()
    mapper = LocalMapping(cfg, Map(), TrackingKernels(cfg, device="cpu"))
    turns = [0]
    real_sleep = time.sleep

    class CountingTime:
        monotonic = staticmethod(time.monotonic)

        @staticmethod
        def sleep(s):
            if threading.current_thread().name == "local_mapping":
                turns[0] += 1
            real_sleep(s)

    monkeypatch.setattr(lm_mod, "time", CountingTime)
    mapper.start()
    try:
        mapper.request_stop()
        assert mapper.wait_until_stopped(timeout=DEADLINE)
        mapper.queue.append(12345)  # no such KF: discarded when popped
        t0 = turns[0]
        _wait(lambda: turns[0] >= t0 + 50, "the parked thread's turns")
        assert list(mapper.queue) == [12345]
        assert mapper.stopped
        mapper.release()
        _wait(lambda: not mapper.queue, "the released thread's drain")
        _wait(lambda: not mapper.stopped, "the released thread running")
        mapper.drain(timeout=DEADLINE)
    finally:
        mapper.join(timeout=DEADLINE)
    assert mapper._thread is None and mapper.error is None


def test_interrupt_ba_flag():
    """InsertKeyFrame sets the BA-abort flag (local_mapper.cpp:231-235)."""
    cfg = _small_cfg()
    mapper = LocalMapping(cfg, Map(), TrackingKernels(cfg, device="cpu"))
    mapper.abort_ba = False
    mapper.insert_keyframe(7)
    assert mapper.abort_ba
    assert list(mapper.queue) == [7]
    mapper.abort_ba = False
    mapper.interrupt_ba()
    assert mapper.abort_ba


def _started_system(n_frames=14):
    """An online System over the first `n_frames` of the rail, its threads
    running, the map initialized and its queue drained."""
    cfg = _merge_dataclass(Config(), ONLINE_CFG)
    ds = list(SyntheticDataset(cfg, **RAIL))
    sys_ = System(cfg, device="cpu")
    for raw in ds[:n_frames]:
        sys_.run(raw)
    sys_.mapper.drain(DEADLINE)
    assert sys_.tracker.state == tr.OK and sys_.mapper._thread.is_alive()
    return sys_, ds


def _watch_stops(mapper, log):
    """Record every stop request and release of `mapper` into `log`."""
    stop, release = mapper.request_stop, mapper.release

    def request_stop():
        log.append("stop")
        stop()

    def released():
        log.append("release")
        release()

    mapper.request_stop = request_stop
    mapper.release = released


def test_toggles_reset_and_load_map_with_threads_running(tmp_path,
                                                          monkeypatch):
    """With the threads running, localization mode parks the mapper before
    the tracker turns to tracking only; reset stops the mapper before the
    map is cleared and releases it after, with the threads running again;
    load_map parks the old mapper before the saved map replaces the live
    one and starts new threads on it."""
    from sp_orb_slam_tpu_torch.slam import serialize

    sys_, ds = _started_system()
    try:
        # localization mode: the thread parked, the map frozen
        sys_.activate_localization_mode()
        sys_.run(ds[14])
        assert sys_.mapper.stopped and sys_.tracker.only_tracking
        n_kf = sys_.map.n_keyframes()
        for raw in ds[15:18]:
            sys_.run(raw)
        assert sys_.map.n_keyframes() == n_kf
        sys_.deactivate_localization_mode()
        sys_.run(ds[18])
        assert not sys_.tracker.only_tracking
        _wait(lambda: not sys_.mapper.stopped, "the mapper released")

        # reset: stopped while the map is cleared, running after
        log = []
        _watch_stops(sys_.mapper, log)
        clear = sys_.map.clear

        def watched_clear():
            log.append(("clear", sys_.mapper.stopped))
            clear()

        sys_.map.clear = watched_clear
        sys_.reset()
        assert log == ["stop", ("clear", True), "release"], log
        assert sys_.mapper._thread.is_alive() and not sys_.mapper.stopped
        assert sys_.map.n_keyframes() == 0

        # load_map: the old mapper parked and ended, new threads on the
        # loaded map
        for raw in ds[19:31]:
            sys_.run(raw)
        sys_.mapper.drain(DEADLINE)
        path = str(tmp_path / "map.npz")
        sys_.save_map(path)
        old = sys_.mapper
        seen = []
        real_load = serialize.load_map

        def watched_load(*a, **kw):
            seen.append((old.stopped, old._thread))
            return real_load(*a, **kw)

        monkeypatch.setattr(serialize, "load_map", watched_load)
        sys_.load_map(path)
        assert seen == [(True, None)], seen
        assert sys_.mapper is not old and sys_.mapper.map is sys_.map
        assert sys_.mapper._thread.is_alive() and not sys_.mapper.stopped
        assert sys_.map.n_keyframes() > 0
        assert sys_.tracker.state == tr.LOST  # armed for relocalization
    finally:
        sys_._stop_threads()
    assert sys_.mapper._thread is None


@pytest.mark.parametrize("where", ["process", "shutdown"])
def test_backend_exception_surfaces(where):
    """A mapping thread that raises ends, and the System re-raises its
    exception at the next frame or at shutdown instead of running on."""
    sys_, ds = _started_system(n_frames=8)
    boom = RuntimeError("mapping fault")

    def failing(kf):
        raise boom

    sys_.mapper._pipeline = failing
    try:
        i = 8
        while sys_.mapper.error is None:
            assert i < len(ds), "no keyframe reached the mapper"
            sys_.process(ds[i])
            i += 1
            t0 = time.monotonic()
            while (sys_.mapper.error is None and sys_.mapper.queue
                   and time.monotonic() - t0 < DEADLINE):
                time.sleep(1e-3)
        _wait(lambda: not sys_.mapper._thread.is_alive(), "the thread's end")
        with pytest.raises(RuntimeError, match="local mapping") as info:
            if where == "process":
                sys_.process(ds[i])
            else:
                sys_.shutdown(timeout=DEADLINE)
        assert info.value.__cause__ is boom
    finally:
        sys_._stop_threads()


def test_drain_raises_at_its_deadline(monkeypatch):
    """drain raises when its deadline passes with work still queued (the
    JAX package's returns silently)."""
    cfg = _small_cfg()
    mapper = LocalMapping(cfg, Map(), TrackingKernels(cfg, device="cpu"))
    gate = threading.Event()

    def held(kf_id):  # a keyframe the thread holds until the gate opens
        gate.wait(DEADLINE)
        return None

    monkeypatch.setattr(mapper, "_pop_keyframe",
                        lambda: held(mapper.queue.popleft())
                        if mapper.queue else None)
    mapper.start()
    try:
        mapper.queue.append(1)
        with pytest.raises(TimeoutError, match="did not drain"):
            mapper.drain(timeout=0.2)
    finally:
        gate.set()
        mapper.join(timeout=DEADLINE)


def test_fleet_online_two_streams():
    """A 2-stream online fleet for 30 ticks: each stream's mapper runs on
    its own thread between the phased drive's lock holds; 0 LOST, state
    OK on both, and shutdown joins every thread."""
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = _merge_dataclass(Config(), {"dataset": "synthetic",
                                      "online": True})
    n = 30
    streams = [list(SyntheticDataset(cfg, n_frames=n, seed=s))
               for s in (3, 4)]
    fleet = StreamFleet(cfg, 2, params=None, device="cpu")
    for k in range(n):
        fleet.tick([streams[0][k], streams[1][k]])
        if k == 0:
            assert all(s.mapper._thread.is_alive() for s in fleet.systems)
    fleet.shutdown()
    for i, s in enumerate(fleet.systems):
        rep = s.report()
        assert s.tracker.state == tr.OK, (i, rep)
        assert rep["n_lost"] == 0, (i, rep)
        assert s.mapper._thread is None and not s.mapper.queue, i
    assert fleet.n_batched_dust > n, fleet.n_batched_dust
