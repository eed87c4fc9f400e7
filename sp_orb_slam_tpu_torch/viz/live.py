"""Live viewer: the reference's Pangolin window and menu as a small HTTP
server for a headless host.

The port keeps its own copy of the JAX package's viz/live.py.  The
reference's interactive observability is a GL window with a side menu of
atomics (src/viz/viewer.cpp:56-126): Follow/Pause/Step/Reset/Localization
checkboxes, the tracking overlay and the map view.  LiveViewer serves the
same three things (frame overlay, two-panel map render, state) over HTTP
(stdlib ThreadingHTTPServer), with POST endpoints that drive the same
System toggles the menu writes (`System.paused` / `step_once` /
`request_system_reset` / `activate_localization_mode`).

Renders are lazy: tracking publishes only object references; drawing and
PNG encoding happen when a client asks, under the map's update lock, which
in the online mode also keeps the mapping thread out while the map is
read.  The renders take no other lock inside it.  An unwatched system pays
nothing for its viewer.

Usage:
    viewer = LiveViewer(system)           # system.viewer is wired
    print(viewer.url)                     # http://127.0.0.1:<port>/
    system.spin(dataset)                  # browse while it runs
    viewer.close()

or `python -m sp_orb_slam_tpu_torch.run_vo --live-port 8080`.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>sp_orb_slam_tpu_torch live</title>
<style>
 body { font-family: sans-serif; background: #181818; color: #ddd;
        margin: 1em; }
 img { border: 1px solid #444; max-width: 48vw; }
 button { margin: 0 0.3em; padding: 0.4em 0.9em; }
 #state { font-family: monospace; white-space: pre; }
</style></head><body>
<h3>sp_orb_slam_tpu_torch</h3>
<div>
 <button onclick="ctl('pause')">pause</button>
 <button onclick="ctl('resume')">resume</button>
 <button onclick="ctl('step')">step</button>
 <button onclick="ctl('reset')">reset</button>
 <button onclick="ctl('loc_on')">localization on</button>
 <button onclick="ctl('loc_off')">localization off</button>
</div>
<p id="state">...</p>
<img id="frame" src="/frame.png"> <img id="map" src="/map.png">
<script>
 function ctl(c) { fetch('/control?cmd=' + c, {method: 'POST'}); }
 setInterval(() => {
   document.getElementById('frame').src = '/frame.png?' + Date.now();
   fetch('/state').then(r => r.json()).then(s => {
     document.getElementById('state').textContent =
       JSON.stringify(s, null, 1); });
 }, 500);
 setInterval(() => {
   document.getElementById('map').src = '/map.png?' + Date.now();
 }, 2000);
</script></body></html>"""


class LiveViewer:
    """Serve live tracking and map views and the control toggles of one
    System."""

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0):
        self.system = system
        self._lock = threading.Lock()
        self._raw_image: Optional[np.ndarray] = None
        self._frame = None
        self._dust_pids = None
        self._state = "INIT"

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif path == "/frame.png":
                        self._send(200, viewer._render_frame_png(),
                                   "image/png")
                    elif path == "/map.png":
                        self._send(200, viewer._render_map_png(),
                                   "image/png")
                    elif path == "/state":
                        self._send(200,
                                   json.dumps(viewer._state_json(),
                                              default=float).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:  # a failed render keeps the server up
                    try:
                        self._send(500, repr(e).encode(), "text/plain")
                    except OSError:
                        pass

            def do_POST(self):
                path, _, query = self.path.partition("?")
                cmd = query.partition("=")[2]
                if path != "/control":
                    self._send(404, b"not found", "text/plain")
                    return
                ok = viewer._control(cmd)
                self._send(200 if ok else 400,
                           json.dumps({"ok": ok, "cmd": cmd}).encode(),
                           "application/json")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="live-viewer")
        self._thread.start()
        system.viewer = self

    # ------------------------------------------------------------- publish

    def publish(self, raw, frame, state: str, dust_pids=None) -> None:
        """Called by System._post_track after tracking: stores references
        only; all rendering is deferred to request time."""
        with self._lock:
            self._raw_image = None if raw is None else raw.image
            self._frame = frame
            self._dust_pids = dust_pids
            self._state = state

    # ------------------------------------------------------------ renders

    def _render_frame_png(self) -> bytes:
        from PIL import Image

        from sp_orb_slam_tpu_torch.viz.frame_drawer import draw_frame

        with self._lock:
            frame, img = self._frame, self._raw_image
            pids, state = self._dust_pids, self._state
        if frame is None:
            arr = np.zeros((120, 160, 3), np.uint8)
        else:
            sys_ = self.system
            with sys_.map.update_lock:
                arr = draw_frame(frame, sys_.map, dust_pids=pids, image=img,
                                 K_intr=sys_.kernels.K_np, state=state)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    def _render_map_png(self) -> bytes:
        from sp_orb_slam_tpu_torch.viz.map_drawer import draw_map

        buf = io.BytesIO()
        sys_ = self.system
        with sys_.map.update_lock:
            # trajectory() walks culled keyframes' parent chains (kf.Tcp):
            # read outside the lock it races a keyframe erase
            _, poses = sys_.trajectory()
            traj = poses[:, :3, 3] if len(poses) else None
            draw_map(sys_.map, buf, current_kf=sys_.tracker.ref_kf,
                     trajectory=traj, fmt="png")
        return buf.getvalue()

    def _state_json(self) -> dict:
        sys_ = self.system
        rep = dict(sys_.report())
        rep["state"] = self._state
        rep["paused"] = sys_.paused
        rep["localization_mode"] = sys_.tracker.only_tracking
        return rep

    # ------------------------------------------------------------ controls

    def _control(self, cmd: str) -> bool:
        """The Pangolin menu atomics (viewer.cpp:56-126 -> system.cpp
        b_pause/b_step/b_system_reset/b_local_on/b_local_off)."""
        sys_ = self.system
        if cmd == "pause":
            sys_.paused = True
        elif cmd == "resume":
            sys_.paused = False
        elif cmd == "step":
            sys_.step_once = True
        elif cmd == "reset":
            sys_.request_system_reset()
        elif cmd == "loc_on":
            sys_.activate_localization_mode()
        elif cmd == "loc_off":
            sys_.deactivate_localization_mode()
        else:
            return False
        return True

    def close(self) -> None:
        """Stop the server, join its thread and unbind `system.viewer`."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        if getattr(self.system, "viewer", None) is self:
            self.system.viewer = None
