"""The one traffic generator: a traffic file's parameters and a seed in,
the frames of every stream out.

A traffic file (`portbench/traffic/<name>.json`) states

- `driver`: the driver module (`portbench/drivers/<driver>.py`) that serves
  this mix;
- `streams`: B, the cameras served together, one batch row each;
- `frames`: F, each stream's consecutive frames, played forwards and then
  backwards (0, 1, .., F-1, F-2, .., 1, 0, 1, ..), so that every step pairs
  a frame with its true predecessor;
- `trajectory_frames`: the length of the rendered loop trajectory the F
  frames are cut from;
- `in_flight`: the batches handed in before the oldest one's results are
  collected (a closed loop);
- `warmup_steps`, `profile_steps`, `check_frames`: the steps run before the
  window, the steps traced after it in a `--trace 1` run, and how many of
  the window's frames the correctness check samples.

Each stream is its own room: the room's texture seed, its sensor-noise
seed and the first of its F frames are drawn from `--seed`, so every seed
gives the same sizes and the same work in another room.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

from portbench import render

KEYS = ("driver", "streams", "frames", "trajectory_frames", "in_flight",
        "warmup_steps", "profile_steps", "check_frames")


def check(traffic: dict) -> dict:
    """The traffic file's parameters, refused if one is missing or out of
    range."""
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    for k in KEYS[1:]:
        if not isinstance(traffic[k], int) or traffic[k] < 0:
            raise ValueError(f"traffic {k} must be a whole number >= 0")
    if traffic["streams"] < 1 or traffic["frames"] < 2:
        raise ValueError("traffic needs >= 1 stream and >= 2 frames")
    if traffic["frames"] > traffic["trajectory_frames"]:
        raise ValueError("traffic frames exceed the trajectory")
    if traffic["in_flight"] < 1:
        raise ValueError("traffic in_flight must be >= 1")
    return traffic


def streams(traffic: dict, seed: int) -> list[tuple[int, int, int]]:
    """(room seed, noise seed, first frame) of each stream, from `seed`."""
    rng = np.random.default_rng([int(seed), 0x7261])
    n = traffic["streams"]
    rooms = rng.integers(0, 2 ** 62, size=n)
    noise = rng.integers(0, 2 ** 62, size=n)
    first = rng.integers(0, traffic["trajectory_frames"] - traffic["frames"]
                         + 1, size=n)
    return [(int(r), int(z), int(f)) for r, z, f in zip(rooms, noise, first)]


def frame_of_step(step: int, frames: int) -> int:
    """The frame index a step plays: forwards then backwards, period
    2 (F - 1)."""
    p = step % (2 * (frames - 1))
    return p if p < frames else 2 * (frames - 1) - p


def _tasks(traffic, seed):
    F = traffic["frames"]
    per_task = max(1, -(-traffic["streams"] * F // 32))
    out = []
    for b, (room, noise, first) in enumerate(streams(traffic, seed)):
        idx = list(range(first, first + F))
        for lo in range(0, F, per_task):
            out.append((b, lo, idx[lo:lo + per_task], room, noise))
    return out


def render_all(camera: dict, traffic: dict, seed: int,
               workers: int | None = None) -> np.ndarray:
    """All frames as (B, F, H, W) uint8, rendered in a pool of spawned
    processes (`workers`, default the CPU count up to 8; 0 renders in this
    process).  The pool has ended when this returns."""
    traffic = check(traffic)
    B, F = traffic["streams"], traffic["frames"]
    H, W = int(camera["height"]), int(camera["width"])
    out = np.empty((B, F, H, W), np.uint8)
    tasks = _tasks(traffic, seed)
    args = [(camera, traffic["trajectory_frames"], room, noise, idx)
            for _, _, idx, room, noise in tasks]
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if workers == 0:
        parts = [render.render_frames(*a) for a in args]
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(workers, len(args)), mp_context=ctx) as pool:
            parts = list(pool.map(render.render_frames, *zip(*args)))
    for (b, lo, idx, _, _), part in zip(tasks, parts):
        out[b, lo:lo + len(idx)] = part
    return out


def batches(frames: np.ndarray) -> list[np.ndarray]:
    """Each frame index's batch (B, H, W) as a host float32 array in [0, 1]:
    the extractor's documented input, made before the window."""
    return [np.ascontiguousarray(frames[:, f].astype(np.float32) / 255.0)
            for f in range(frames.shape[1])]
