"""Per-frame overlay rendering (FrameDrawer equivalent).

The port keeps its own copy of the JAX package's viz/frame_drawer.py.
Reference: viz/frame_drawer.cpp —
- updateCoarse (:60-121): project the dust-candidate map points into the
  current frame and draw a 5 px box + dot per point, coloured yellow when
  not in view, red when in view but unmatched, green when dust-matched;
- update (:~123+): draw the tracked keypoints of the fine stage.

The canvas is the grayscale frame when the image path is active, or black
for injected-feature runs; output is an (H, W, 3) uint8 array / PNG.  The
frame's host mirrors (uv, valid, mp_ids, outlier, occ_grid, Tcw) and the
map's host pools are all it reads: `K_intr` is the host copy of the
intrinsics (TrackingKernels.K_np), never the device tensor.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

YELLOW = (255, 255, 0)
RED = (255, 60, 60)
GREEN = (60, 255, 60)
BLUE = (90, 150, 255)
WHITE = (230, 230, 230)


def _box(img: np.ndarray, u: int, v: int, r: int, color) -> None:
    H, W, _ = img.shape
    u0, u1 = max(u - r, 0), min(u + r, W - 1)
    v0, v1 = max(v - r, 0), min(v + r, H - 1)
    img[v0, u0:u1 + 1] = color
    img[v1, u0:u1 + 1] = color
    img[v0:v1 + 1, u0] = color
    img[v0:v1 + 1, u1] = color


def _dot(img: np.ndarray, u: int, v: int, color, r: int = 1) -> None:
    H, W, _ = img.shape
    img[max(v - r, 0):min(v + r + 1, H), max(u - r, 0):min(u + r + 1, W)] = color


def draw_frame(frame, world, dust_pids: Optional[List[int]] = None,
               image: Optional[np.ndarray] = None,
               K_intr: Optional[np.ndarray] = None,
               state: str = "") -> np.ndarray:
    """Render the tracking overlay for one frame.

    frame: FrameData (pose + keypoints + bindings); world: Map;
    dust_pids: the coarse-stage candidate point ids (status colours);
    image: optional (H, W) grayscale canvas; K_intr: host [fx, fy, cx, cy].
    """
    if image is not None:
        canvas = np.repeat(image[..., None], 3, axis=-1).astype(np.uint8)
        H, W = image.shape
    else:
        # infer extents from the occupancy grid (cell size 8)
        hc, wc = frame.occ_grid.shape
        H, W = hc * 8, wc * 8
        canvas = np.zeros((H, W, 3), np.uint8)

    # keypoints: white = unbound, blue = bound to a map point
    for i in np.nonzero(frame.valid)[0]:
        u, v = int(frame.uv[i, 0]), int(frame.uv[i, 1])
        if not (0 <= u < W and 0 <= v < H):
            continue
        bound = frame.mp_ids[i] >= 0 and not frame.outlier[i]
        _dot(canvas, u, v, BLUE if bound else WHITE, r=1 if bound else 0)

    # dust-candidate status boxes (frame_drawer.cpp:81-120)
    if dust_pids and frame.Tcw is not None and K_intr is not None:
        R, t = frame.Tcw[:3, :3], frame.Tcw[:3, 3]
        for pid in dust_pids:
            mp = world.points.get(pid)
            if mp is None or mp.bad:
                continue
            if not mp.in_view:
                color = YELLOW
            elif not mp.dust_match:
                color = RED
            else:
                color = GREEN
            Pc = R @ world.pool.pos[mp.pid] + t
            if Pc[2] <= 0:
                continue
            u = int(K_intr[0] * Pc[0] / Pc[2] + K_intr[2])
            v = int(K_intr[1] * Pc[1] / Pc[2] + K_intr[3])
            if 5 <= u < W - 5 and 5 <= v < H - 5:
                _box(canvas, u, v, 5, color)
                _dot(canvas, u, v, color)

    # state banner: a coloured strip along the top (OK green / LOST red /
    # INIT yellow), since there is no font dependency
    strip = {"OK": GREEN, "LOST": RED}.get(state, YELLOW)
    canvas[:3, :] = strip
    return canvas


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)
