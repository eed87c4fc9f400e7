"""Ray-cast renders of a textured box room: the benchmark's own frames.

A frozen copy of the port's numpy renderer (`io/render.py`, with the two
trajectories it needs from `io/dataset.py`), kept here so that the
benchmark's traffic cannot move when the program's renderer changes.  The
same (room seed, noise seed, frame index) gives the same uint8 image as
the port's `RenderedDataset(Config(), n_frames, seed, noise_seed)`.

Numpy only: this module is imported by spawned render workers, which must
start fast and must not load the program or torch.
"""

from __future__ import annotations

import numpy as np

# room bounds (the loop trajectory is a radius-2 circle with centre
# (x, z) = (0, 2); every wall 2-4 m from the camera)
XMIN, XMAX = -4.5, 4.5
YMIN, YMAX = -2.5, 2.5
ZMIN, ZMAX = -2.5, 6.5
SENSOR_NOISE = 2.0  # grey levels, the renderer's default


def loop_trajectory(n: int) -> np.ndarray:
    """A closed circle (camera yawing to face outward) returning to the
    start."""
    poses = []
    radius = 2.0
    for i in range(n):
        t = i / n
        ang = 2 * np.pi * t
        pos = np.array([radius * np.sin(ang), 0.08 * np.sin(4 * np.pi * t),
                        radius * (1 - np.cos(ang))])
        c, s = np.cos(ang), np.sin(ang)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def rendered_loop_trajectory(n: int, lead: int = 45) -> np.ndarray:
    """A lateral out-and-back strafe lead-in, then the closed circle."""
    lead = min(lead, n // 4)
    if lead == 0:
        return loop_trajectory(n)
    poses = []
    for i in range(lead):
        t = i / max(lead, 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-0.35 * np.sin(np.pi * t), 0.02 * np.sin(2 * np.pi * t),
                    0.0]
        poses.append(T)
    return np.concatenate([np.stack(poses), loop_trajectory(n - lead)])


def _noise_grids(rng: np.random.Generator, octaves: int = 6,
                 base: int = 10):
    return [rng.standard_normal((base * 2 ** o + 1, base * 2 ** o + 1))
            .astype(np.float32) for o in range(octaves)]


def _eval_noise(grids, s: np.ndarray, t: np.ndarray,
                persistence: float = 0.8) -> np.ndarray:
    v = np.zeros_like(s, dtype=np.float32)
    amp = 1.0
    for g in grids:
        n = g.shape[0] - 1
        x = np.clip(s, 0.0, 1.0) * n
        y = np.clip(t, 0.0, 1.0) * n
        x0 = np.minimum(x.astype(np.int32), n - 1)
        y0 = np.minimum(y.astype(np.int32), n - 1)
        fx = (x - x0).astype(np.float32)
        fy = (y - y0).astype(np.float32)
        v += amp * ((1 - fy) * ((1 - fx) * g[y0, x0] + fx * g[y0, x0 + 1])
                    + fy * ((1 - fx) * g[y0 + 1, x0] + fx * g[y0 + 1, x0 + 1]))
        amp *= persistence
    return v


class Room:
    """One textured room seen by a pinhole camera along the rendered loop
    trajectory of `n_frames` poses."""

    def __init__(self, camera: dict, n_frames: int, seed: int,
                 noise_seed: int | None):
        self.K = np.array([camera["fx"], camera["fy"], camera["cx"],
                           camera["cy"]], np.float32)
        self.H, self.W = int(camera["height"]), int(camera["width"])
        self.noise_seed = noise_seed
        self.poses = rendered_loop_trajectory(n_frames)
        rng = np.random.default_rng(seed)
        self.faces = []
        for axis, bound in ((0, XMIN), (0, XMAX), (1, YMIN), (1, YMAX),
                            (2, ZMIN), (2, ZMAX)):
            s_axis, t_axis = [a for a in range(3) if a != axis]
            self.faces.append((axis, bound, s_axis, t_axis,
                               _noise_grids(rng)))
        self._lims = np.array([[XMIN, XMAX], [YMIN, YMAX], [ZMIN, ZMAX]],
                              np.float32)
        uu, vv = np.meshgrid(np.arange(self.W, dtype=np.float32),
                             np.arange(self.H, dtype=np.float32))
        self._rays = np.stack([(uu - self.K[2]) / self.K[0],
                               (vv - self.K[3]) / self.K[1],
                               np.ones_like(uu)], -1)

    def _trace(self, o: np.ndarray, d: np.ndarray):
        lead = d.shape[:-1]
        best_t = np.full(lead, np.inf, np.float32)
        val = np.zeros(lead, np.float32)
        for a, b, sa, ta, grids in self.faces:
            da = d[..., a]
            safe = np.where(np.abs(da) < 1e-9, 1e-9, da)
            t = (b - o[a]) / safe
            X = o[(None,) * len(lead) + (slice(None),)] + t[..., None] * d
            (s0, s1), (t0, t1) = self._lims[sa], self._lims[ta]
            hit = ((t > 1e-3) & (t < best_t)
                   & (X[..., sa] >= s0 - 1e-3) & (X[..., sa] <= s1 + 1e-3)
                   & (X[..., ta] >= t0 - 1e-3) & (X[..., ta] <= t1 + 1e-3))
            if not hit.any():
                continue
            s = (X[..., sa][hit] - s0) / (s1 - s0)
            tt = (X[..., ta][hit] - t0) / (t1 - t0)
            val[hit] = _eval_noise(grids, s, tt)
            best_t[hit] = t[hit]
        return best_t, val

    def frame(self, i: int) -> np.ndarray:
        """Frame i as an (H, W) uint8 image, with seeded sensor noise."""
        Twc = self.poses[i]
        d = self._rays @ Twc[:3, :3].astype(np.float32).T
        best_t, val = self._trace(Twc[:3, 3].astype(np.float32), d)
        img = 0.5 + 0.28 * val
        img = img * (1.0 / (1.0 + 0.03 * np.minimum(best_t, 20.0)))
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if self.noise_seed is not None:
            rng = np.random.default_rng((int(self.noise_seed) + 1) * 100003
                                        + i)
            img = np.clip(img.astype(np.float32)
                          + rng.normal(0, SENSOR_NOISE, img.shape),
                          0, 255).astype(np.uint8)
        return img


def render_frames(camera: dict, n_frames: int, seed: int,
                  noise_seed: int | None, idx: list[int]) -> np.ndarray:
    """Frames `idx` of one room as (len(idx), H, W) uint8: the work of one
    render task."""
    room = Room(camera, n_frames, seed, noise_seed)
    return np.stack([room.frame(i) for i in idx])
