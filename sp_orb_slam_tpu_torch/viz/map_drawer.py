"""Map snapshot rendering (MapDrawer equivalent).

The port keeps its own copy of the JAX package's viz/map_drawer.py.
Reference: viz/map_drawer.cpp (:74-310) draws points, keyframe frusta, the
covisibility graph, spanning tree, and the current BA participants in a
Pangolin GL view.  Here: a two-panel matplotlib figure (top-down x/z and
side x/y) written to PNG — points, covisibility edges, keyframe centres,
the current keyframe and the trajectory, minus interactivity.
"""

from __future__ import annotations

import numpy as np


def draw_map(world, path, current_kf: int = -1,
             trajectory: np.ndarray = None, fmt: str = None) -> None:
    """`path` is a filename or a file-like object (pass `fmt="png"` for
    the latter — the live viewer renders into a BytesIO).  Reads the map's
    host state only; the caller holds `world.update_lock` when another
    thread may write the map."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.stack([world.pool.pos[mp.pid]
                    for mp in world.points.values() if not mp.bad]) \
        if world.points else np.zeros((0, 3))
    kfs = [(kf.kf_id, kf.Ow, kf) for kf in world.keyframes.values()
           if not kf.bad]

    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    for ax, (a, b, la, lb) in zip(axes, [(0, 2, "x", "z"), (0, 1, "x", "y")]):
        if len(pts):
            ax.scatter(pts[:, a], pts[:, b], s=1.0, c="#666666", alpha=0.4,
                       label=f"{len(pts)} points")
        # covisibility edges (map_drawer.cpp graph view)
        for kid, Ow, kf in kfs:
            for nid in kf.ordered_neighbors[:10]:
                other = world.keyframes.get(nid)
                if other is not None and not other.bad and nid > kid:
                    ax.plot([Ow[a], other.Ow[a]], [Ow[b], other.Ow[b]],
                            c="#9ecae1", lw=0.5, zorder=1)
        if kfs:
            kp = np.stack([Ow for _, Ow, _ in kfs])
            ax.scatter(kp[:, a], kp[:, b], s=14, c="#1f77b4", marker="s",
                       zorder=3, label=f"{len(kfs)} keyframes")
        cur = world.keyframes.get(current_kf)
        if cur is not None:
            ax.scatter([cur.Ow[a]], [cur.Ow[b]], s=40, c="#2ca02c",
                       marker="s", zorder=4)
        if trajectory is not None and len(trajectory):
            ax.plot(trajectory[:, a], trajectory[:, b], c="#d62728", lw=1.0,
                    zorder=2, label="trajectory")
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_aspect("equal", adjustable="datalim")
    handles, labels = axes[0].get_legend_handles_labels()
    if handles:
        axes[0].legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110, format=fmt)
    plt.close(fig)
