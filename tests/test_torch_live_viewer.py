"""The port's LiveViewer (viz/live.py) and the System's pause / step gate
on the CPU: the HTTP endpoints and their content types, lazy renders, the
six menu controls and the 400 for any other command
(tests/test_live_viewer.py), a paused `spin` on its own thread that
advances exactly one frame per `step`, and `run_vo --live-port 0`.  Every
wait has a deadline."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam.system import System
from sp_orb_slam_tpu_torch.viz.live import LiveViewer
from test_torch_system import SMALL

torch.set_num_threads(2)

DEADLINE = 60.0  # seconds any wait of these tests may take


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(url):
    """(status, the JSON reply, or None for a reply that is not JSON)."""
    req = urllib.request.Request(url, method="POST", data=b"")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, None


def _wait(cond, what):
    end = time.monotonic() + DEADLINE
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _cfg():
    return _merge_dataclass(Config(), SMALL)


def test_live_viewer_endpoints_and_controls():
    cfg = _cfg()
    system = System(cfg, device="cpu")
    viewer = LiveViewer(system)
    try:
        base = viewer.url.rstrip("/")
        assert system.viewer is viewer

        # before any frame: the page, a placeholder render and the state
        st, ct, body = _get(base + "/")
        assert st == 200 and "text/html" in ct
        assert b"sp_orb_slam_tpu_torch" in body
        st, ct, body = _get(base + "/frame.png")
        assert st == 200 and ct == "image/png" and body[:4] == b"\x89PNG"
        st, ct, body = _get(base + "/state")
        assert st == 200 and ct == "application/json"
        assert json.loads(body)["state"] == "INIT"

        # drive frames so real overlays and map renders exist
        for raw in SyntheticDataset(cfg, n_frames=12, seed=1):
            system.process(raw)

        st, ct, body = _get(base + "/frame.png")
        assert st == 200 and body[:4] == b"\x89PNG" and len(body) > 1000
        st, ct, body = _get(base + "/map.png")
        assert st == 200 and ct == "image/png" and body[:4] == b"\x89PNG"
        st, _, body = _get(base + "/state")
        rep = json.loads(body)
        assert rep["state"] == "OK" and rep["n_keyframes"] >= 1, rep
        assert rep["paused"] is False and rep["localization_mode"] is False

        # the menu toggles drive the System's flags
        st, out = _post(base + "/control?cmd=pause")
        assert st == 200 and out == {"ok": True, "cmd": "pause"}
        assert system.paused
        _post(base + "/control?cmd=step")
        assert system.step_once
        _post(base + "/control?cmd=resume")
        assert not system.paused
        _post(base + "/control?cmd=loc_on")
        assert system._local_on
        st, out = _post(base + "/control?cmd=bogus")
        assert st == 400 and not out["ok"]
        st, _ = _post(base + "/elsewhere?cmd=pause")
        assert st == 404
        st, _, _ = _get(base + "/nope")
        assert st == 404
    finally:
        viewer.close()
    assert system.viewer is None


# each control and what it writes on the System
CONTROLS = {"pause": lambda s: s.paused,
            "resume": lambda s: not s.paused,
            "step": lambda s: s.step_once,
            "reset": lambda s: s._system_reset,
            "loc_on": lambda s: s._local_on and not s._local_off,
            "loc_off": lambda s: s._local_off and not s._local_on}


@pytest.mark.parametrize("cmd", list(CONTROLS) + ["", "PAUSE", "stop"])
def test_control_command(cmd):
    system = System(_cfg(), device="cpu")
    system.paused = cmd == "resume"
    viewer = LiveViewer(system)
    try:
        st, out = _post(viewer.url + f"control?cmd={cmd}")
    finally:
        viewer.close()
    if cmd in CONTROLS:
        assert st == 200 and out == {"ok": True, "cmd": cmd}
        assert CONTROLS[cmd](system)
    else:
        assert st == 400 and out == {"ok": False, "cmd": cmd}
        assert not (system.paused or system.step_once or system._local_on
                    or system._system_reset)


def test_paused_spin_advances_one_frame_per_step():
    """A spin started paused processes nothing until `step`, then exactly
    one frame per `step`, and runs to its end after `resume`."""
    cfg = _cfg()
    system = System(cfg, device="cpu")
    viewer = LiveViewer(system)
    n_frames = 6
    started = []
    process = system.process

    def counted(raw):
        started.append(raw)
        process(raw)

    system.process = counted
    system.paused = True
    failed = []

    def spin():
        try:
            system.spin(SyntheticDataset(cfg, n_frames=n_frames, seed=1))
        except Exception as e:  # reported by the main thread
            failed.append(e)

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    try:
        time.sleep(0.5)
        assert not started and system.frame_id == 0
        for k in (1, 2):
            st, _ = _post(viewer.url + "control?cmd=step")
            assert st == 200
            _wait(lambda: system.frame_id == k and not system.step_once,
                  f"frame {k}")
            time.sleep(0.3)  # still paused: no further frame starts
            assert len(started) == k and system.frame_id == k
        _, _, body = _get(viewer.url + "state")
        assert json.loads(body)["paused"] is True
        _post(viewer.url + "control?cmd=resume")
        t.join(timeout=DEADLINE)
        assert not t.is_alive() and not failed, failed
        assert system.frame_id == n_frames and len(started) == n_frames
    finally:
        system.paused = False
        t.join(timeout=DEADLINE)
        viewer.close()


def test_run_vo_live_port(tmp_path, capsys):
    from sp_orb_slam_tpu_torch import run_vo

    assert run_vo.main(["--dataset", "synthetic", "--device", "cpu",
                        "--synthetic-frames", "6", "--live-port", "0",
                        "--output", str(tmp_path)]) == 0
    err = capsys.readouterr().err
    assert "live viewer: http://127.0.0.1:" in err
