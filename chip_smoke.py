#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sp_orb_slam_tpu_torch).

    python3 chip_smoke.py [--kernels [KERNEL ...]]

Needs one NVIDIA Hopper card (H100), PyTorch for CUDA and `nvcc`; imports no
JAX.  Phases, each of which raises on failure (`--kernels`: phases 1-2
only, for the named kernels or all seven, printing the kernel rows and no
`ok` line):

1. the card: `torch.cuda.get_device_name(0)` and `nvidia-smi`'s name and
   power limit; build every kernel from `sp_orb_slam_tpu_torch/csrc/` (one
   `nvcc` per source, all at once) and print `-Xptxas -v`'s register,
   shared-memory and spill report;
2. kernels: each of the seven kernels against its plain PyTorch version
   on the card at the step's shapes (B=32, 752x480, K=896) with seeded
   inputs (pair1 also at the fleet's B=8, with its persistent grid
   checked; match also at B=1), then CUDA-event times of the kernel (its
   own pair of events around each call), its plain version and, where one
   PyTorch call computes the same function, that call (desc_sparse, which
   samples the raw convDb map, casts and normalises the corner rows and
   zeroes invalid slots: checked in bfloat16 and float32 at B=32 and in
   float32 at B=1 on a raw map with a valid prefix of each image's slots,
   and on a unit map with every slot valid against `sample_descriptors`,
   timed in both types at B=32 beside the library composite
   where(valid, normalize(grid_sample(normalize(raw)))), with its
   registers and spill bytes, 0 spills required); the kernel's device
   time alone (torch.profiler's device events) and its host µs a call
   (each call waited for); every one of these with L2 flushed before each
   call (128 MB written outside the timed window), and no time may read
   under its bound; each kernel's times and bound again at the batch of the
   path that launches it (pair1 B=8, NMS / cov / desc_sparse / match B=1,
   pair1t and desc_dense B=2); the two first-conv-pair designs, pair1 and
   pair1t, against each other at B=32, 8 and 1 (CUDA events) and, in
   device time alone in turns, at B=32, 8, 2 and 1, where pair1t is also
   held against its plain version, with its registers and spill bytes
   (0 required); match beside torch.bmm of
   the same descriptors (the product alone); NMS compared at the batches
   of its paths and of the step (1, 8 and 32) and timed with a cluster of
   1 and of 8 blocks an image at each; NMS and cov at iters 0, 1 and 16
   (the set-up apart from the rounds), then again on the float32
   frontend's own outputs for the SLAM room's 220 frames, against their
   plain versions, with the rounds each fixed point needs there; then a
   table of the times with the launch floor, an empty kernel timed the
   same way;
3. frontend paths: frames 0 and 2 of the rendered room through
   `make_extractor(..., device="cuda")` in bfloat16 with the trained
   weights (weights/sp_rendered.npz), then `match_init_batch`; keypoint,
   match and ray-cast precision gates, through pair1 (conv_packing
   "auto") and again through pair1t (conv_packing="pair1t"); the same in
   float32 with the kernels and with the plain versions, which must agree;
   then the float32 extractor with desc_method "pallas_sparse" and
   "pallas" against "gather", and with cov_method "dense" (the same
   responses, median relative cov2 difference < 0.1, cov2 >= 1) and
   "none" (unit covariance, zero response) beside the cov kernel's;
   then the JAX package's space-to-depth lowerings (conv_packing "s2d",
   "s2d2", "s2d3", which the port runs as "none"), measured: the first
   three conv pairs with the first 1, 2 or 3 on the packed layout against
   all three unpacked, in float32 on frames 0 and 2 of room 5 within 1e-5 of
   max |unpacked|, then timed at B=32, 752x480 in both dtypes (CUDA
   events, in turns); and the SuperPoint forward alone at B=32 for
   float32 and bfloat16 "none", pair1 and pair1t;
4. step time: the extract + init-match step of bench.py (B=32, bfloat16,
   through pair1) as frames/s over the wall time of 50 steps;
5. profile: the same step under torch.profiler, with the device's idle
   share and device time per step by layer and by kernel;
6. SLAM: `System(cfg, params, device="cuda").spin(...)` over the first 120
   of the 220 frames of the held-out rendered room (cut from all 220 for
   the time limit) at the default configuration (752x480, K=896,
   float32): gates on LOST frames, the tracked share and the Sim3 ATE; ms
   per frame of `System.process` and of each `Timer` span over an
   unprofiled spin of the first 119 frames; the device's idle share over
   the last frame, spun under torch.profiler, and there the device time of
   NMS, cov and desc_sparse as the path runs them (phase 2 times them
   from a cold L2);
7. the fleet: `StreamFleet(cfg, 8, params, device="cuda")` in bfloat16
   (conv_packing="auto": the pair1 kernel) over 8 held-out rendered rooms
   (texture seeds 4-11, 80 frames each, the last stream ending after 72):
   per-stream gates on LOST frames, the tracked share and the Sim3 ATE;
   launch gates (pair1, nms, cov and desc_sparse once per tick, pair1t
   never, match at least once per stream); ms per tick and the spans over
   the unprofiled ticks, the idle share over the last tick profiled
   apart; then the localization leg: stream 0's map saved, a new 8-stream
   fleet loads it in localization mode and runs 10 ticks of seed 4's
   frames, gated on relocalization, the share of ticks with a pose and the
   frozen map, with the spans of its slowest tick beside its median's;
8. SLAM with loop closing: `System(cfg, params, device="cuda")` with
   `use_loop` and the fitted NetVLAD checkpoint (weights/vlad_rendered.npz)
   over room 5's 220 frames (on which the JAX package closes the room's
   loop at this configuration): gates a loop closed, 0 LOST, >= 80 %
   tracked, ATE < 0.2, NMS / cov / desc_sparse launched once a frame and
   match at least once; ms per frame of `System.process` and the spans,
   the `loop` span of each frame that runs a Sim3 attempt or a loop
   event, split by the loop closer's stages, the loops' keyframe ids, and
   the ATE beside phase 6's (loop closing off, its 120 frames);
9. online SLAM with loop closing: phase 8's System with `online=True`,
   mapping, loop closing and the post-loop global BA on their own threads
   beside tracking, `warmup()` timed, then `spin` over room 5's 220
   frames from memory (it ends with `shutdown`: drained, joined): ms per
   frame of `System.process` (tracking alone) and of the wall, the
   mapping thread's ms per keyframe and its BA solves, the loops, the GBA
   solve and commit by thread, the shutdown's drain, the ATE beside
   phases 6 and 8; gates: 0 LOST, >= 176 of 220 tracked, ATE < 0.2,
   every thread joined and queue empty, no backend exception, NMS / cov /
   desc_sparse launched once a frame and match once an init attempt
   counted from zero after warmup, no `TrackingKernels` stage called that
   warmup did not call (`spy_stages`), and a global BA committed from its
   own thread (where no loop closed, a forced leg runs it over the
   online map, the caller taking the map lock while it solves);
10. the variants off the defaults: phase 6's System with the heat coarse
   tracker and the epipolar-walk triangulation (coarse_method="heat",
   matching_method=2) over the first 40 of phase 6's frames: gates 0
   LOST and ATE < 0.2, nms / cov / desc_sparse once a frame and match at
   least once, the heat stage called and no dust stage (`spy_stages`),
   method-2 triangulation rows dispatched and map points committed from
   them; ms per frame, `System.process` and the spans beside phase 6's
   over the same frames;
10b. the fleet under the heat tracker: `StreamFleet(cfg, 2, params,
   device="cuda")` in bfloat16 (pair1), warmed up, over 30 ticks of phase
   7's rooms 4 and 5: gates 0 LOST per stream, the heat stage on every
   stream and no dust stage, pair1 / nms / cov / desc_sparse once a tick;
   ms per tick;
11. training (train/superpoint_train.py; cuDNN convs and autograd, since
   the JAX package's training reaches no Pallas kernel): (a) the port's
   build_pool at 320x240 (2 scenes x 16 pairs, fx 260: the checkpoint's
   training camera) and with Config()'s 752x480 camera (1 x 8), with
   their corner-cell and corresponding-cell shares; (b) one step at B=2,
   320x240 from weights/sp_rendered.npz on the card against the port's CPU
   path on the same batch (the loss terms, the 24 gradients, the updated
   parameters, at stated tolerances); (c) `train` from init_params(seed
   0), 200 steps at B=8, 320x240: every logged loss finite and its fall
   at least the gate set from the JAX package's CPU run; (d) ms per step
   (CUDA events, 20 steps after warm-up), images/s and peak memory at B=8
   at both sizes, and a few steps profiled for the idle share and the
   device time by kernel group; (e) (c)'s state through `save_npz` into a
   temporary directory, reloaded (JAX's keys and shapes), then the
   bfloat16 extractor (pair1, NMS, cov, desc_sparse) and the init matcher
   on frames 0 and 2 of room 5: finite outputs and keypoints;
12. the viewer and the stream mesh: (a) phase 6's System with
   `set_debug_dir` and a `LiveViewer` on a free port over the first 40
   frames of room 5, a client thread GETting /, /frame.png, /map.png and
   /state and POSTing pause (no frame may start for 1 s), step (exactly
   one frame) and resume: gates a frame PNG of (480, 752, 3) per frame,
   >= 2 map PNGs, > 50 status-coloured pixels, /state OK, 0 LOST, NMS /
   cov / desc_sparse once a frame and match at least once; ms per frame of
   `System.process` beside phase 6's over the same frames and the render
   times (what draws with a module that does not import is left out,
   with a line saying so: without matplotlib the debug dir, /map.png and
   the map render, without PIL also the overlay and /frame.png); (b) `build_sharded_step` at B=8 (rooms 4-11, frame 2
   against frame 0), bfloat16, on a 1-slot mesh and a 2-slot mesh of this
   card against the unsharded `multi_stream_step`: features, matches,
   inliers and Tcw (1e-4) stream by stream, pair1 / NMS / cov /
   desc_sparse / match once a chunk, ms per step; (c) a 2-stream bfloat16
   fleet with a 2-slot mesh of this card beside one without a mesh over
   30 ticks of rooms 4 and 5: 0 LOST, >= 30 % of the ticks tracked and
   ATE < 0.2 per stream in both, the extraction, a dust and a local stage
   split over 2 slots, every split dust / local batch re-run unsplit with
   its poses within 5e-4, launches once a slot a tick, ms per tick; the
   two fleets' keypoints and poses compared and stated (their extractions
   run at different batches).  One card shows the split and the gather,
   not scaling across cards;
13. the tools (sp_orb_slam_tpu_torch/scripts/, through their functions):
   (a) validate_weights on the committed checkpoint at 752x480 (phase 3's
   keypoint, match and precision gates); (b) vlad_rendered_stats; (c) the
   default fit_vlad_centroids run into a temporary directory (the file
   loads through load_params, the selected revisit - distinct margin
   above the random codebook's and its distinct median under the 0.2
   candidate floor, the random codebook's over it; the committed
   weights/vlad_rendered.npz scored on the same frames beside it); (d)
   replay_degenerate, seed 1, depth filter off and on, 80 frames
   (tests/test_depth_filter.py's gates); (e) accuracy_sweep, seeds 1-3 x
   50 frames (0 LOST, no failed seed, each ATE < 0.1); (d)'s two runs and
   (e)'s three seeds in five processes of their own beside (a)-(c); NMS /
   cov /
   desc_sparse launched in (a)-(c), match in (a), (d) and (e); every
   kernel output of (a)-(c) and (e), at each input shape the tools give
   the kernel, held against its plain version on the same inputs.

Every path is driven with the launch counters zeroed just before it and
read just after (phase 9: after its warmup), and fails if a kernel of that
path never launched.  The
rendered frames of phases 6 and 7 are made before phase 2, in one process
per CPU core.
Prints a `kernels` JSON line (each kernel's launches on its path and, as
`launches_heat`, in phase 10, pair1's in phase 10b, as `launches_viz` in
phase 12 (a), as `launches_mesh` in phase 12 (c)'s mesh fleet and as
`launches_tools` over phase 13; NMS, cov and desc_sparse also their
device ms a launch in phase 6's profiled frame, `path_device_ms`), the
card's name and power limit, and as the last line {"ok": true, "device":
{...}}.  Exits
non-zero, printing no result, without a card or without the repository
around it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, H, W, K = 32, 480, 752, 896
H100_BF16 = 989e12   # dense bf16 tensor-core FLOP/s (H100 SXM data sheet)
H100_F32 = 67e12     # f32 FLOP/s outside the tensor cores
H100_BYTES = 3.35e12  # HBM bytes/s
STEP_BLOCKS, STEP_BLOCK = 5, 10   # timed blocks x steps per block
PROFILE_STEPS, PROFILE_ROWS = 5, 60  # profiled steps, kernel rows printed
# device_split's windows: the profiler can return no device event for a
# window several times in a row
PROFILE_WINDOWS = 8
# written between a kernel's timed launches, outside the timed window: 2.5x
# the H100's 50 MB L2, so each launch reads its inputs from HBM, as the
# bounds assume (back to back, a B=2 desc_dense run read its 23 MB from L2
# and timed under its HBM bound)
FLUSH_BYTES = 128 << 20


def log(*a):
    print(*a, flush=True)


@functools.lru_cache(maxsize=None)
def _flush_buffer(index):
    import torch

    return torch.empty(FLUSH_BYTES // 2, dtype=torch.int16,
                       device=torch.device("cuda", index))


def flush_l2():
    """Overwrite FLUSH_BYTES on the current card: whatever a timed launch
    reads after this comes from HBM, not from L2."""
    import torch

    _flush_buffer(torch.cuda.current_device()).fill_(1)


@functools.lru_cache(maxsize=None)
def flush_keys(iters=4):
    """The profiler's names for `flush_l2`'s device work, which
    `device_split` leaves out of a kernel's time: the events of `iters`
    flushes, each come back `iters` times, in one of PROFILE_WINDOWS
    windows (the profiler can return no device event for a window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush_l2()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush_l2()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and not ev.key.startswith("ProfilerStep")]
        if rows and all(ev.count == iters for ev in rows):
            return frozenset(ev.key for ev in rows)
    raise AssertionError(f"profiler: the L2 flush's device events missing "
                         f"in {PROFILE_WINDOWS} windows; the last: "
                         f"{[(ev.key, ev.count) for ev in rows]}")


def cuda_ms(fn, iters=10, warmup=2):
    """Time of fn() in ms a call over `iters` back-to-back calls, between
    two CUDA events: the device time, or the host's time to issue a call
    where that is longer (a small batch)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flushed_ms(fn, iters=10, warmup=2):
    """A kernel row's time of fn() in ms a call: L2 flushed before each of
    `iters` calls, outside the call's own pair of CUDA events (the device
    time, or the host's time to issue the call where that is longer)."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def event_device_us(ev):
    """Device µs of one key_averages() row."""
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def device_split(fn, iters=20):
    """Device time of fn() alone in ms a call, by device event name: the
    durations of the kernels and memsets it launches, from torch.profiler's
    device events over `iters` calls after one warm-up call, L2 flushed
    before each call; no host time, no gap between launches and none of
    the flush's events (`flush_keys`, each come back once a call) counts.
    A window in which some device event did not come back a multiple of
    `iters` times (the profiler can drop events, or, rarely, return none
    in a window) is taken again, up to PROFILE_WINDOWS windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    skip = flush_keys()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        every = [ev for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA
                 and not ev.key.startswith("ProfilerStep")]
        rows = [ev for ev in every if ev.key not in skip]
        flushes = sorted(ev.count for ev in every if ev.key in skip)
        split = {ev.key: event_device_us(ev) / 1e3 / iters for ev in rows}
        if (sum(split.values()) > 0
                and all(ev.count % iters == 0 for ev in rows)
                and flushes == [iters] * len(skip)):
            return split
    raise AssertionError(f"profiler: device events missing in "
                         f"{PROFILE_WINDOWS} windows; the last: "
                         f"{[(ev.key, ev.count) for ev in rows]}")


def short_name(kernel_name):
    """A profiler kernel name without its namespace, return type and
    arguments."""
    name = kernel_name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()


def device_ms(fn, iters=20):
    """Device time of fn() alone in ms a call (device_split, summed)."""
    return sum(device_split(fn, iters).values())


def host_us(fn, iters=50):
    """Wall µs a call when each call is waited for (L2 flushed and the
    card idle, then fn() and synchronize, `iters` times after one warm-up
    call): what one call costs a caller that reads its result, host work
    and launch included."""
    import torch

    fn()
    total = 0.0
    for _ in range(iters):
        flush_l2()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total * 1e6 / iters


def kernel_times(fn, iters):
    """ms (CUDA events around each call), device_ms (device time alone)
    and host_us (each call waited for) of one wrapper call, each with L2
    flushed before every call."""
    return dict(ms=flushed_ms(fn, iters), device_ms=device_ms(fn),
                host_us=host_us(fn))


def render_frames(seed, n_total, idx):
    """Frames `idx` of the held-out rendered room `seed` (a trajectory of
    `n_total` frames, sensor noise seed 0) at the default camera: the
    worker of `render_all`."""
    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset

    ds = RenderedDataset(Config(), n_frames=n_total, seed=seed, noise_seed=0)
    return [ds.frame(i) for i in idx]


def render_all(jobs):
    """{seed: frames} for jobs {seed: (n_total, n_frames)}, rendered in one
    process per CPU core (the pool stops when it returns)."""
    tasks = [(seed, n_total, list(range(lo, min(lo + 25, n))))
             for seed, (n_total, n) in jobs.items() for lo in range(0, n, 25)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=os.cpu_count() or 1, mp_context=ctx) as pool:
        parts = list(pool.map(render_frames, *zip(*tasks)))
    out = {seed: [] for seed in jobs}
    for (seed, _, _), part in zip(tasks, parts):
        out[seed] += part
    return out


def bound_ms(nbytes, flops, peak):
    t_bytes = nbytes / H100_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def at_launch_shape(row, nb, call, bound, iters):
    """Add to `row` the kernel's times and bound at the batch size `nb` of
    the path that launches it (`call(nb)` runs the kernel on the first nb
    rows of phase 2's inputs, `bound(nb)` is (ms, by) for those rows)."""
    bms, by = bound(nb)
    times = kernel_times(lambda: call(nb), iters)
    row.update(launch_batch=nb, launch_bound_ms=bms, launch_bound_by=by,
               **{f"launch_{k}": v for k, v in times.items()})
    return row


def launch_floor(dev):
    """The empty kernel of csrc/noop.cu through `_build.launch`, timed as
    the kernels are: the share of a small batch's time that no kernel
    body can remove."""
    from sp_orb_slam_tpu_torch.ops import _build

    return kernel_times(lambda: _build.noop(dev), 50)


ROW_KEYS = ("name", "max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launch_batch",
            "launch_ms", "launch_device_ms", "launch_host_us",
            "launch_bound_ms", "launch_bound_by")


def kernel_table(rows, floor, smi):
    """Phase 2's table: each kernel's times at B=32 and at its path's batch
    (ms: CUDA events around each call; dev: device time alone; host µs:
    each call waited for), beside its bound, and the floor.  L2 is flushed
    before each call: cold-cache readings, where a path's kernel may find
    its inputs in L2 (phase 6 prints the SLAM path's own times)."""
    lines = [f"kernel times, L2 flushed before each call | {smi}",
             f"{'kernel':<12} {'ms':>8} {'dev ms':>8} {'host us':>8} "
             f"{'bound':>8} | {'B':>2} {'ms':>8} {'dev ms':>8} "
             f"{'host us':>8} {'bound':>8}"]
    lines += [f"{r['name']:<12} {r['ms']:8.4f} {r['device_ms']:8.4f} "
              f"{r['host_us']:8.1f} {r['bound_ms']:8.5f} | "
              f"{r['launch_batch']:>2} {r['launch_ms']:8.4f} "
              f"{r['launch_device_ms']:8.4f} {r['launch_host_us']:8.1f} "
              f"{r['launch_bound_ms']:8.5f}" for r in rows]
    lines.append(f"{'noop floor':<12} {floor['ms']:8.4f} "
                 f"{floor['device_ms']:8.4f} {floor['host_us']:8.1f} "
                 f"(the empty kernel through _build.launch)")
    return lines


def check_bounds(rows):
    """No time of a kernel row may read under its bound: one that does was
    measured from a warm cache or against a wrong count."""
    under = [f"{r['name']} {col} {r[col]:.5f} < {r[bound]:.5f}"
             for r in rows
             for col, bound in (("ms", "bound_ms"), ("device_ms", "bound_ms"),
                                ("launch_ms", "launch_bound_ms"),
                                ("launch_device_ms", "launch_bound_ms"))
             if r[col] < r[bound]]
    if under:
        raise AssertionError(f"kernel times under their bounds: {under}")


SPLIT_ITERS = (0, 1, 16)  # rounds of the NMS / cov fixed points timed apart


def rounds_split(name, call):
    """Log the device time alone of `call(nb, iters)` at B=32 and B=1 for
    each of SPLIT_ITERS: iters=0 runs the set-up alone (loads, masks,
    output), so the rest of the time at 16 is what the rounds cost."""
    parts = []
    for nb in (B, 1):
        ts = [device_ms(lambda: call(nb, it)) for it in SPLIT_ITERS]
        parts.append(f"B={nb} " + " / ".join(f"{t:.4f}" for t in ts))
    log(f"{name} set-up and rounds: device ms at iters "
        f"{' / '.join(map(str, SPLIT_ITERS))}: {'; '.join(parts)}")


# ---------------------------------------------------------------- phase 2


def pair_inputs(state, gen, dev):
    """Seeded images and the trained first-pair weights at B=32, 752x480,
    with the cuDNN bf16 pair (channels-last) on them: the yardstick."""
    import torch
    import torch.nn.functional as F

    images = torch.rand((B, H, W), generator=gen, device=dev)
    w = [state[k].to(dev) for k in ("conv1a.weight", "conv1a.bias",
                                    "conv1b.weight", "conv1b.bias")]
    wb = [x.to(torch.bfloat16) for x in w]
    xb = images.to(torch.bfloat16)[:, None].contiguous(
        memory_format=torch.channels_last)
    wa_cl = wb[0].contiguous(memory_format=torch.channels_last)
    wb_cl = wb[2].contiguous(memory_format=torch.channels_last)

    def library():
        y = F.relu(F.conv2d(xb, wa_cl, wb[1], padding=1))
        return F.max_pool2d(F.relu(F.conv2d(y, wb_cl, wb[3], padding=1)), 2)

    def bound(nb):
        flops = 2.0 * nb * H * W * 64 * (9 + 64 * 9)
        nbytes = nb * H * W * 4 + nb * (H // 2) * (W // 2) * 64 * 2
        return bound_ms(nbytes, flops, H100_BF16)

    return images, w, library, bound


def ptxas_entries(log_text, kernel):
    """{entry function: [registers, spill store bytes, spill load bytes]}
    of each entry function whose mangled name holds `kernel`, from nvcc's
    -Xptxas -v."""
    found, mine = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            entry = line.split("'")[1] if "'" in line else line.split()[-1]
            mine = (found.setdefault(entry, [None, None, None])
                    if kernel in entry else None)
        elif mine and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            mine[1], mine[2] = int(m[1]), int(m[2])
        elif mine and (m := re.search(r"Used (\d+) registers", line)):
            mine[0] = int(m[1])
    return found


def ptxas_report(log_text, kernel):
    """(registers, spill store bytes, spill load bytes) of the one entry
    function whose mangled name holds `kernel` (all None without one)."""
    entries = list(ptxas_entries(log_text, kernel).values())
    return tuple(entries[0]) if len(entries) == 1 else (None, None, None)


PAIR_BATCHES = (B, 8, 2, 1)  # the step, the fleet, pair1t's path, one image


def check_pair1t(state, gen, dev, build_logs):
    """The transposed-GEMM kernel against its plain version at B=32, 8, 2
    and 1 (the first rows of one batch), with the gate of
    tests/test_torch_pair1t.py: conv1b's f32 sums in another order, so a
    value may move one bf16 ulp: rtol 1e-2, atol 1e-3, more than 99 %
    bit-identical.  The launch is a persistent grid of min(tiles, SMs x
    resident blocks).  Logs its registers and spill bytes (0 spills
    required), and its device time alone beside the pair1 kernel's on the
    same inputs at each batch, in turns (pair1t, pair1, pair1, pair1t)."""
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_pair1, cuda_pair1t

    regs, stores, loads = ptxas_report(build_logs.get("pair1t", ""),
                                       "pair1t_kernel")
    log(f"pair1t_kernel: {regs} registers, {stores} bytes spill stores, "
        f"{loads} bytes spill loads")
    if regs is None or stores or loads:
        raise AssertionError("pair1t kernel: no ptxas report, or spills")
    images, w, library, bound = pair_inputs(state, gen, dev)
    bms, by = bound(B)
    want = cuda_pair1t.fused_pair1t_plain(images, *w).float()
    errs = []
    for nb in PAIR_BATCHES:
        got = cuda_pair1t.fused_pair1t(images[:nb], *w)
        torch.cuda.synchronize()
        g, t = got.float(), want[:nb]
        err = (g - t).abs()
        # 1 bf16 ulp is <= 2^-7 relative; atol covers outputs near 0, where
        # a one-ulp flip of an upstream y1 value moves the sum by ~1e-4
        bad = int((err > 1e-2 * t.abs() + 1e-3).sum())
        same = float((g == t).float().mean())
        grid, blocks, sms = cuda_pair1t.launch_grid(nb, H, W, dev)
        tiles = cuda_pair1t.tiles(nb, H, W)
        log(f"pair1t B={nb}: max_abs_err {float(err.max()):.3e}, "
            f"bit-identical {same:.6f}, outside rtol=1e-2/atol=1e-3: {bad}; "
            f"grid {grid} for {tiles} tiles, {blocks} blocks an SM x {sms} "
            f"SMs")
        if (got.shape != (nb, H // 2, W // 2, 64) or bad or same <= 0.99
                or blocks < 1 or grid != min(tiles, sms * blocks)):
            raise AssertionError("pair1t disagrees with its plain version")
        errs.append(float(err.max()))
    for nb in PAIR_BATCHES:
        x = images[:nb]
        t1, p1, p2, t2 = (device_ms(lambda: f(x, *w)) for f in (
            cuda_pair1t.fused_pair1t, cuda_pair1.fused_pair1,
            cuda_pair1.fused_pair1, cuda_pair1t.fused_pair1t))
        log(f"pair1t B={nb}: device ms {t1:.4f}, {t2:.4f}; the pair1 kernel "
            f"{p1:.4f}, {p2:.4f} on the same inputs; bound "
            f"{bound(nb)[0]:.4f} ms")
    row = dict(
        name="pair1t", route="cuda",
        source="sp_orb_slam_tpu_torch/csrc/pair1t.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_pair1t.py:257",
        max_abs_err=max(errs),
        **kernel_times(lambda: cuda_pair1t.fused_pair1t(images, *w), 20),
        plain_ms=flushed_ms(
            lambda: cuda_pair1t.fused_pair1t_plain(images, *w), iters=5),
        bound_ms=bms, bound_by=by, library_ms=flushed_ms(library))
    # its path: the bf16 frontend of phase 3 with conv_packing="pair1t"
    return at_launch_shape(
        row, 2, lambda nb: cuda_pair1t.fused_pair1t(images[:nb], *w), bound,
        iters=20)


def check_pair1(state, gen, dev):
    """The persistent kernel against its plain version (the stock bf16
    pair) at B=32 and at the fleet's B=8, with the tolerances of
    tests/test_pallas_pair1.py: bf16 operands and f32 sums in another order
    (conv1a on the tensor cores), so a y1 value may round one bf16 ulp
    apart and move an output by up to two ulps: atol 0.03, rtol 0.02, more
    than 95 % bit-identical.  The launch is a persistent grid of
    min(tiles, SMs x resident blocks), at least one block an SM.  Times it
    beside its plain version, the cuDNN pair and the pair1t kernel at
    B=32, 8 and 1 (the step, the fleet, one image)."""
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_pair1, cuda_pair1t

    images, w, library, bound = pair_inputs(state, gen, dev)
    bms, by = bound(B)
    want = cuda_pair1.fused_pair1_plain(images, *w).float()
    other = cuda_pair1t.fused_pair1t(images, *w).float()
    errs = []
    for nb in (B, 8):
        g = cuda_pair1.fused_pair1(images[:nb], *w).float()
        t, o = want[:nb], other[:nb]
        err = (g - t).abs()
        bad = int((err > 0.02 * t.abs() + 0.03).sum())
        same = float((g == t).float().mean())
        same_t = float((g == o).float().mean())
        grid, blocks, sms = cuda_pair1.launch_grid(nb, H, W, dev)
        tiles = cuda_pair1.tiles(nb, H, W)
        log(f"pair1 B={nb}: max_abs_err {float(err.max()):.3e}, "
            f"bit-identical {same:.6f} (vs the pair1t kernel {same_t:.6f}), "
            f"outside rtol=0.02/atol=0.03: {bad}; grid {grid} for {tiles} "
            f"tiles, {blocks} blocks an SM x {sms} SMs")
        if (g.shape != (nb, H // 2, W // 2, 64) or bad or same <= 0.95
                or blocks < 1 or grid != min(tiles, sms * blocks)):
            raise AssertionError("pair1 disagrees with its plain version")
        errs.append(float(err.max()))
    times = {}
    for nb in (B, 8, 1):
        x = images[:nb]
        times[nb] = (flushed_ms(lambda: cuda_pair1.fused_pair1(x, *w), 20),
                     flushed_ms(lambda: cuda_pair1t.fused_pair1t(x, *w), 20))
        log(f"pair1 B={nb}: {times[nb][0]:.4f} ms, the pair1t kernel "
            f"{times[nb][1]:.4f} ms on the same inputs, bound "
            f"{bound(nb)[0]:.4f} ms")
    row = dict(
        name="pair1", route="cuda",
        source="sp_orb_slam_tpu_torch/csrc/pair1.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_pair1.py:250",
        max_abs_err=max(errs),
        **kernel_times(lambda: cuda_pair1.fused_pair1(images, *w), 20),
        plain_ms=flushed_ms(
            lambda: cuda_pair1.fused_pair1_plain(images, *w), iters=5),
        bound_ms=bms, bound_by=by, library_ms=flushed_ms(library))
    # its path: the bf16 fleet, 8 streams
    return at_launch_shape(
        row, 8, lambda nb: cuda_pair1.fused_pair1(images[:nb], *w), bound,
        iters=20)


# the batches NMS runs at on the paths (SLAM 1, fleet 8) and in the step
NMS_BATCHES = (1, 8, B)


def nms_agrees(what, score, uv, valid, dist, iters, batches=NMS_BATCHES):
    """The kernel against `greedy_grid_nms` on the first nb images for each
    nb in `batches`, logging the blocks an image the wrapper picks at each;
    raises on any cell that differs.  The cells that differ at the largest
    batch."""
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_nms
    from sp_orb_slam_tpu_torch.ops.nms import greedy_grid_nms

    sms = torch.cuda.get_device_properties(
        score.device).multi_processor_count
    parts, diffs = [], []
    for nb in batches:
        got = cuda_nms.batched_grid_nms(score[:nb], uv[:nb], valid[:nb],
                                        dist=dist, iters=iters)
        want = greedy_grid_nms(score[:nb], uv[:nb], valid[:nb], dist=dist,
                               iters=iters)
        diffs.append(int((got != want).sum()))
        parts.append(f"B={nb}, cluster {cuda_nms.cluster_size(nb, sms)}: "
                     f"{diffs[-1]} (kept {int(got.sum())})")
    log(f"{what}: cells differing from the plain version: "
        f"{'; '.join(parts)}")
    if any(diffs):
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version")
    return diffs[-1]


def check_nms(gen, dev):
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_nms
    from sp_orb_slam_tpu_torch.ops.nms import (greedy_grid_nms,
                                               greedy_grid_nms_reference)

    hc, wc = H // 8, W // 8
    score = torch.rand((B, hc, wc), generator=gen, device=dev)
    score = torch.round(score * 50) / 50          # force score ties
    u = (torch.arange(wc, device=dev) * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=dev)).to(torch.int32)
    v = (torch.arange(hc, device=dev)[:, None] * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=dev)).to(torch.int32)
    uv = torch.stack([u, v], -1).contiguous()
    valid = torch.rand((B, hc, wc), generator=gen, device=dev) < 0.5
    diff = nms_agrees("nms", score, uv, valid, 4, 16)
    got = cuda_nms.batched_grid_nms(score, uv, valid, dist=4, iters=16)
    gold = greedy_grid_nms_reference(score[0].cpu(), uv[0].cpu(),
                                     valid[0].cpu(), dist=4)
    same = bool((got[0].cpu().numpy() == gold).all())
    log(f"nms: image 0 vs golden equal: {same}")
    if not same:
        raise AssertionError("nms disagrees with its golden model")

    def bound(nb):
        return bound_ms(nb * hc * wc * (4 + 8 + 1 + 1), 0.0, H100_F32)

    rounds_split("nms", lambda nb, it: cuda_nms.batched_grid_nms(
        score[:nb], uv[:nb], valid[:nb], dist=4, iters=it))
    parts = []
    for nb in NMS_BATCHES:
        ts = [device_ms(lambda: cuda_nms._launch(
            score[:nb], uv[:nb], valid[:nb], 4, 16, c)) for c in (1, 8)]
        parts.append(f"B={nb} " + " / ".join(f"{t:.4f}" for t in ts))
    log(f"nms device ms with a cluster of 1 / 8 blocks an image (iters "
        f"16): "
        f"{'; '.join(parts)}")
    bms, by = bound(B)
    row = dict(
        name="nms", route="cuda", source="sp_orb_slam_tpu_torch/csrc/nms.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_nms.py:121",
        max_abs_err=float(diff),  # cells that differ (a bool mask)
        **kernel_times(lambda: cuda_nms.batched_grid_nms(score, uv, valid),
                       50),
        plain_ms=flushed_ms(lambda: greedy_grid_nms(score, uv, valid),
                            iters=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    return at_launch_shape(row, 1, lambda nb: cuda_nms.batched_grid_nms(
        score[:nb], uv[:nb], valid[:nb]), bound, iters=50)


def check_cov(gen, dev):
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_cov
    from sp_orb_slam_tpu_torch.ops.covariance import keypoint_covariance

    # smooth peaked heat map in [0, 1] with plateaus and ties, like heat_inv
    heat = torch.rand((B, 1, H // 4, W // 4), generator=gen, device=dev)
    heat = torch.nn.functional.interpolate(heat, size=(H, W),
                                           mode="bilinear")[:, 0]
    heat = torch.round(heat * 256) / 256
    uv = torch.stack([
        torch.randint(8, W - 8, (B, K), generator=gen, device=dev),
        torch.randint(8, H - 8, (B, K), generator=gen, device=dev)],
        -1).float().contiguous()
    valid = torch.rand((B, K), generator=gen, device=dev) > 0.1
    c_k, ci_k, r_k = cuda_cov.batched_covariance(heat, uv, valid)
    c_p, ci_p, r_p = keypoint_covariance(heat, uv, valid)
    torch.cuda.synchronize()
    err = float((c_k - c_p).abs().max())
    resp_equal = bool(torch.equal(r_k, r_p))
    log(f"cov: cov2 max_abs_err {err:.3e}, cov2_inv max_abs_err "
        f"{float((ci_k - ci_p).abs().max()):.3e}, response equal "
        f"{resp_equal}")
    if err > 1e-5 or not resp_equal:
        raise AssertionError("cov disagrees with its plain version")
    def bound(nb):
        n_valid = int(valid[:nb].sum())
        nbytes = n_valid * 17 * 17 * 4 + nb * K * (8 + 1 + 20)
        return bound_ms(nbytes, 0.0, H100_F32)

    rounds_split("cov", lambda nb, it: cuda_cov.batched_covariance(
        heat[:nb], uv[:nb], valid[:nb], radius=8, iters=it))
    bms, by = bound(B)
    row = dict(
        name="cov", route="cuda", source="sp_orb_slam_tpu_torch/csrc/cov.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_cov.py:189", max_abs_err=err,
        **kernel_times(lambda: cuda_cov.batched_covariance(heat, uv, valid),
                       50),
        plain_ms=flushed_ms(lambda: keypoint_covariance(heat, uv, valid),
                            iters=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    return at_launch_shape(row, 1, lambda nb: cuda_cov.batched_covariance(
        heat[:nb], uv[:nb], valid[:nb]), bound, iters=50)


def match_disagreements(args, m12_k, m12_p, window=100, ratio=0.9):
    """Rows (b, r) where the kernel's match12 differs from the plain
    version's, and how many of them are near-ties: a disagreement is
    excused only where the plain version's competing distances (best vs
    second, best vs the TH_LOW / ratio thresholds, or two rows claiming one
    column) are within 1e-5 of each other.  `window` and `ratio`: the
    call's own."""
    import torch

    from sp_orb_slam_tpu_torch.ops import matching as mt

    d1, v1, uv1, d2, uv2, v2 = args
    bad = (m12_k != m12_p).nonzero().tolist()
    excused = 0
    for b, r in bad:
        dist = mt.pairwise_dist(d1[b], d2[b]).double()
        mask = mt.window_mask(uv1[b], v1[b], uv2[b], v2[b], window)
        dd = torch.where(mask, dist, mt.BIG)[r]
        two = torch.topk(dd, 2, largest=False).values
        best, second = float(two[0]), float(two[1])
        gaps = [second - best, abs(best - mt.TH_LOW),
                abs(best - ratio * second)]
        col = int(dd.argmin())
        colmins = torch.where(mask, dist, mt.BIG)[:, col]
        others = torch.cat([colmins[:r], colmins[r + 1:]])
        gaps.append(float((others - best).abs().min()))
        excused += min(gaps) < 1e-5
    return bad, excused


def check_match(gen, dev):
    import torch

    from sp_orb_slam_tpu_torch.models.superpoint import unit_rows
    from sp_orb_slam_tpu_torch.ops import cuda_match
    from sp_orb_slam_tpu_torch.ops.matching import init_match
    from sp_orb_slam_tpu_torch.utils.precision import full_f32

    D = 256
    d1 = unit_rows(torch.randn((B, K, D), generator=gen, device=dev))
    # frame 2: noisy copies of frame 1 (true matches near 0.1-0.3) plus a
    # block of exact duplicates that forces distance ties
    noise = torch.randn((B, K, D), generator=gen, device=dev)
    scale = torch.rand((B, K, 1), generator=gen, device=dev) * 0.03
    perm = torch.randperm(K, generator=gen, device=dev)
    d2 = unit_rows(d1[:, perm] + scale * noise)
    d2[:, K - 64:] = d2[:, :64]
    uv1 = (torch.rand((B, K, 2), generator=gen, device=dev)
           * torch.tensor([W, H], device=dev)).contiguous()
    uv2 = (uv1 + (torch.rand((B, K, 2), generator=gen, device=dev) - 0.5)
           * 120).contiguous()
    v1 = torch.rand((B, K), generator=gen, device=dev) > 0.1
    v2 = torch.rand((B, K), generator=gen, device=dev) > 0.1
    d2 = d2.contiguous()
    args = (d1, v1, uv1, d2, uv2, v2)
    m12_k, n_k, m21_k = cuda_match.match_init_batch(*args)
    m12_p, n_p, m21_p = init_match(*args)
    torch.cuda.synchronize()
    bad, excused = match_disagreements(args, m12_k, m12_p)
    n_rows = B * K
    log(f"match: {len(bad)} rows differ from the plain version, {excused} "
        f"of them near-ties (< 1e-5), of {n_rows} rows; matches kernel "
        f"{int(n_k.sum())} / plain {int(n_p.sum())}")
    if excused != len(bad) or excused >= 1e-3 * n_rows:
        raise AssertionError("match disagrees with its plain version")
    # the SLAM init's batch of one (another tile size) against the same rows
    one = tuple(a[:1] for a in args)
    m12_1 = cuda_match.match_init_batch(*one)[0]
    bad1, excused1 = match_disagreements(one, m12_1, m12_p[:1])
    log(f"match B=1: {len(bad1)} rows differ, {excused1} near-ties")
    if excused1 != len(bad1):
        raise AssertionError("match at B=1 disagrees with its plain version")
    def bound(nb):
        flops = 2.0 * nb * K * K * D
        nbytes = 2 * nb * K * (D * 4 + 8 + 1) + nb * K * 8 + nb * 4
        return bound_ms(nbytes, flops, H100_F32)

    bms, by = bound(B)
    row = dict(
        name="match", route="cuda",
        source="sp_orb_slam_tpu_torch/csrc/match.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_match.py:137",
        max_abs_err=float(len(bad)),  # rows whose match index differs
        **kernel_times(lambda: cuda_match.match_init_batch(*args), 20),
        plain_ms=flushed_ms(lambda: init_match(*args), iters=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    row = at_launch_shape(row, 1, lambda nb: cuda_match.match_init_batch(
        *(a[:nb] for a in args)), bound, iters=50)
    # a partial yardstick: a tuned f32 product of the same descriptor sets
    # (TF32 off), the product alone and not the whole function
    d2t = d2.transpose(1, 2)
    with full_f32():
        prod = {nb: kernel_times(lambda: torch.bmm(d1[:nb], d2t[:nb]), 20)
                for nb in (B, 1)}
    for nb in (B, 1):
        split = device_split(lambda: cuda_match.match_init_batch(
            *(a[:nb] for a in args)))
        log(f"match B={nb} device time by kernel: " + ", ".join(
            f"{short_name(k)} {v * 1e3:.1f} us"
            for k, v in sorted(split.items(), key=lambda x: -x[1])))
    log("match yardstick, torch.bmm in f32 (TF32 off), the product alone "
        "and not the whole function: " + "; ".join(
            f"B={nb}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms"
            for nb, t in prod.items()) + "; the match kernel: " +
        f"B={B}: {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; "
        f"B=1: {row['launch_ms']:.4f} ms, device "
        f"{row['launch_device_ms']:.4f} ms")
    return row


def _unit_coarse(gen, dev):
    import torch

    from sp_orb_slam_tpu_torch.models.superpoint import unit_rows

    return unit_rows(torch.randn((B, H // 8, W // 8, 256), generator=gen,
                                 device=dev))


# valid slots an image, as the frontend's counts run: up to its cap of
# num_features + 1 = 801 (sp_extractor.cpp:210-213)
DESC_VALID = (700, 801)


def check_desc_sparse(gen, dev, build_logs):
    """The fused sampler (the raw convDb map to masked unit descriptors)
    against its plain version on a seeded raw map whose rows are not unit,
    K=896 keypoints inside the NMS border and a valid prefix of each
    image's slots, DESC_VALID long, as the extractor emits them: bfloat16
    and float32 at B=32, float32 at the SLAM path's B=1 (1e-5, finite,
    invalid rows exactly 0); and on a unit map with every slot valid
    against `sample_descriptors`, the TPU kernel's function.  Logs each
    instantiation's registers and spill bytes (0 spills required).  The
    row is float32 (B=32, and B=1 at its path); the bfloat16 times at
    B=32, the step's, are logged beside it and held to their bound.  The
    bound counts what this data needs: the distinct raw rows the valid
    slots' corners touch, 9 B of uv and valid and 1 KiB out a slot.  The
    library yardstick is the same function as PyTorch calls:
    where(valid, normalize(grid_sample(normalize(raw.float())))), at B=32
    in both types and at B=1."""
    import torch
    import torch.nn.functional as F

    from sp_orb_slam_tpu_torch.models.superpoint import sample_descriptors
    from sp_orb_slam_tpu_torch.ops import cuda_desc

    entries = ptxas_entries(build_logs.get("desc_sparse", ""),
                            "desc_sparse_kernel")
    for entry, (regs, stores, loads) in entries.items():
        log(f"desc_sparse {entry}: {regs} registers, {stores} bytes spill "
            f"stores, {loads} bytes spill loads")
    if len(entries) != 2 or any(r is None or st or ld
                                for r, st, ld in entries.values()):
        raise AssertionError("desc_sparse kernel: no ptxas report for its "
                             "two instantiations, or spills")
    hc, wc = H // 8, W // 8
    scale = torch.rand((B, hc, wc, 1), generator=gen, device=dev) * 8 + 0.5
    raw32 = torch.randn((B, hc, wc, 256), generator=gen, device=dev) * scale
    raws = {"f32": raw32, "bf16": raw32.to(torch.bfloat16)}
    # keypoints inside the NMS border, as the extractor emits them
    uv = torch.stack([8 + torch.rand((B, K), generator=gen, device=dev)
                      * (W - 16),
                      8 + torch.rand((B, K), generator=gen, device=dev)
                      * (H - 16)], -1).contiguous()
    n_valid = torch.randint(DESC_VALID[0], DESC_VALID[1] + 1, (B, 1),
                            generator=gen, device=dev)
    valid = torch.arange(K, device=dev)[None, :] < n_valid

    def kernel(dt, nb):
        return cuda_desc.sample_descriptors_sparse(
            raws[dt][:nb], uv[:nb], valid[:nb], (H, W))

    def plain(dt, nb):
        return cuda_desc.sample_descriptors_sparse_plain(
            raws[dt][:nb], uv[:nb], valid[:nb], (H, W))

    errs = []
    for dt, nb in (("bf16", B), ("f32", B), ("f32", 1)):
        got, want = kernel(dt, nb), plain(dt, nb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        zero = bool((got[~valid[:nb]] == 0).all())
        log(f"desc_sparse {dt} B={nb}: max_abs_err {err:.3e} (tolerance "
            f"1e-5), invalid rows zero {zero}, valid slots "
            f"{int(valid[:nb].sum())} of {nb * K}")
        if err > 1e-5 or not zero or not torch.isfinite(got).all():
            raise AssertionError("desc_sparse disagrees with its plain "
                                 "version")
        errs.append(err)
    unit = _unit_coarse(gen, dev)
    got = cuda_desc.sample_descriptors_sparse(
        unit, uv, torch.ones_like(valid), (H, W))
    err = float((got - sample_descriptors(unit, uv, (H, W))).abs().max())
    log(f"desc_sparse on a unit map, every slot valid, against "
        f"sample_descriptors: max_abs_err {err:.3e} (tolerance 1e-5)")
    if err > 1e-5 or not torch.isfinite(got).all():
        raise AssertionError("desc_sparse disagrees with sample_descriptors")
    errs.append(err)

    # bytes this data needs: each distinct row the valid slots' corners
    # touch once, uv and valid, the output
    gx = (uv[..., 0] * (wc - 1) / W).floor().long().clamp(0, wc - 2)
    gy = (uv[..., 1] * (hc - 1) / H).floor().long().clamp(0, hc - 2)
    r0 = gy * wc + gx
    rows = torch.stack([r0, r0 + 1, r0 + wc, r0 + wc + 1], -1)
    rows = rows + torch.arange(B, device=dev)[:, None, None] * hc * wc

    def bound(nb, elem=4):
        n_rows = int(torch.unique(rows[:nb][valid[:nb]]).numel())
        nbytes = n_rows * 256 * elem + nb * K * (8 + 1 + 256 * 4)
        # a valid slot: four corners' squares and weighted sums, then the
        # sum's square and scale
        flops = int(valid[:nb].sum()) * 256 * (4 * 4 + 3.0)
        log(f"desc_sparse B={nb}, {elem} B an element: {n_rows} distinct "
            f"corner rows of {nb * hc * wc}, {nbytes / 1e6:.2f} MB")
        return bound_ms(nbytes, flops, H100_F32)

    grid = (uv / torch.tensor([W / 2, H / 2], device=dev) - 1)[:, None]

    def library(dt, nb):  # the same function as PyTorch calls (yardstick)
        nchw = raws[dt][:nb].permute(0, 3, 1, 2)
        mask = valid[:nb, None, None, :]
        return lambda: torch.where(mask, F.normalize(F.grid_sample(
            F.normalize(nchw.float(), dim=1), grid[:nb],
            align_corners=True), dim=1), 0.0)

    lib_err = float((library("f32", B)()[:, :, 0].transpose(1, 2)
                     - plain("f32", B)).abs().max())
    log(f"desc_sparse: the library composite vs plain {lib_err:.3e}")
    lib_ms = {(dt, nb): flushed_ms(library(dt, nb), iters=20)
              for dt, nb in (("f32", B), ("bf16", B), ("f32", 1))}
    bms, by = bound(B)
    row = dict(
        name="desc_sparse", route="cuda",
        source="sp_orb_slam_tpu_torch/csrc/desc_sparse.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_desc.py:272",
        max_abs_err=max(errs),
        **kernel_times(lambda: kernel("f32", B), 50),
        plain_ms=flushed_ms(lambda: plain("f32", B), iters=10),
        bound_ms=bms, bound_by=by, library_ms=lib_ms["f32", B])
    # the step's type: bfloat16 at B=32, held to its own bound
    bf = kernel_times(lambda: kernel("bf16", B), 50)
    bf_bound, bf_by = bound(B, 2)
    log(f"desc_sparse bf16 B={B}: ms {bf['ms']:.4f}, dev ms "
        f"{bf['device_ms']:.4f}, host us {bf['host_us']:.1f}, bound "
        f"{bf_bound:.5f} ({bf_by}), plain ms "
        f"{flushed_ms(lambda: plain('bf16', B), iters=10):.4f}, library "
        f"ms {lib_ms['bf16', B]:.4f}")
    if min(bf["ms"], bf["device_ms"]) < bf_bound:
        raise AssertionError("desc_sparse bf16 times under their bound")
    at_launch_shape(row, 1, lambda nb: kernel("f32", nb), bound, iters=50)
    log(f"desc_sparse f32 B=1: library ms {lib_ms['f32', 1]:.4f}")
    return row


def check_desc_dense(gen, dev):
    import torch
    import torch.nn.functional as F

    from sp_orb_slam_tpu_torch.models.superpoint import (
        sample_descriptors_dense)
    from sp_orb_slam_tpu_torch.ops import cuda_desc

    hc, wc = H // 8, W // 8
    coarse = _unit_coarse(gen, dev)
    u = torch.arange(wc, device=dev) * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=dev)
    v = torch.arange(hc, device=dev)[:, None] * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=dev)
    cand = torch.stack([u, v], -1).to(torch.int32).contiguous()
    got = cuda_desc.sample_descriptors_dense_batch(coarse, cand, (H, W))
    want = sample_descriptors_dense(coarse, cand, (H, W))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"desc_dense: max_abs_err {err:.3e} (tolerance 1e-5)")
    if err > 1e-5 or not torch.isfinite(got).all():
        raise AssertionError("desc_dense disagrees with its plain version")
    def bound(nb):
        n = nb * hc * wc
        return bound_ms(n * 256 * 4 * 2 + n * 8, n * 256 * 12.0, H100_F32)

    bms, by = bound(B)
    nchw = coarse.permute(0, 3, 1, 2)
    grid = cand.float() / torch.tensor([W / 2, H / 2], device=dev) - 1

    def library():  # the reference's grid_sample + normalize (yardstick)
        return F.normalize(F.grid_sample(nchw, grid, align_corners=True),
                           dim=1)

    lib_err = float((library().permute(0, 2, 3, 1) - want).abs().max())
    log(f"desc_dense: grid_sample + normalize vs plain {lib_err:.3e}")
    row = dict(
        name="desc_dense", route="cuda",
        source="sp_orb_slam_tpu_torch/csrc/desc_dense.cu",
        replaces="sp_orb_slam_tpu/ops/pallas_desc.py:156", max_abs_err=err,
        **kernel_times(lambda: cuda_desc.sample_descriptors_dense_batch(
            coarse, cand, (H, W)), 50),
        plain_ms=flushed_ms(lambda: sample_descriptors_dense(
            coarse, cand, (H, W)), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=flushed_ms(library, iters=20))
    # its path: the frontend of phase 3 with desc_method="pallas", 2 images
    return at_launch_shape(
        row, 2, lambda nb: cuda_desc.sample_descriptors_dense_batch(
            coarse[:nb], cand[:nb], (H, W)), bound, iters=50)


REAL_CHUNK = 20    # frames a forward pass of the frontend
ROUND_CAP = 64     # rounds after which an output counts as final


def rounds_needed(run, same):
    """Per item, the least k in 0..ROUND_CAP with `run(k)` equal to
    `run(ROUND_CAP)`: the rounds a fixed point needs before its output
    stops changing.  `same(a, b)` compares two outputs item by item."""
    import torch

    final = run(ROUND_CAP)
    need = None
    for k in range(ROUND_CAP + 1):
        done = same(run(k), final)
        need = torch.where(done, k, -1) if need is None else torch.where(
            (need < 0) & done, k, need)
        if bool((need >= 0).all()):
            return need
    raise AssertionError("rounds_needed: an output never settled")


def frontend_maps(state, dev, frames):
    """What NMS and cov get on the SLAM path for `frames`: the float32
    frontend's per-cell candidates (score, cand_uv, cand_valid) and
    heat_inv, and the keypoints selected from them (uv, valid)."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.ops.nms import select_keypoints

    cfg = Config()
    ex = cfg.extractor
    hh, ww = cfg.camera.height, cfg.camera.width
    model = SuperPoint(state).to(dev).eval()
    parts = []
    for lo in range(0, len(frames), REAL_CHUNK):
        imgs = np.stack([f.image.astype(np.float32)[:hh, :ww] / 255.0
                         for f in frames[lo:lo + REAL_CHUNK]])
        with torch.inference_mode():
            out = model(torch.from_numpy(imgs).to(dev),
                        conf_thresh=ex.conf_thresh, with_heat=False,
                        with_heat_inv=True)
            kps = select_keypoints(
                out.score, out.cand_uv, out.cand_valid,
                num_features=cfg.tracking.num_features,
                max_keypoints=cfg.runtime.max_keypoints, image_hw=(hh, ww),
                dist=ex.nms_dist, border=ex.border, nms_iters=ex.nms_iters)
        parts.append((out.score, out.cand_uv, out.cand_valid, out.heat_inv,
                      kps.uv, kps.valid))
    return [torch.cat(x).contiguous() for x in zip(*parts)], ex


def check_real(state, dev, frames, names):
    """NMS and cov on the frontend's own outputs for the SLAM room's
    frames, each against its plain version (NMS: 0 cells differing; cov:
    the response equal, cov2 within 1e-5); the rounds each fixed point
    needs there to converge (per image for NMS, per valid keypoint for
    the fill: maximum and median); the kernels' device time alone on
    these inputs at B=1 and B=32.  NMS is compared at the paths' batches
    and at all the frames."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.ops import cuda_cov, cuda_nms
    from sp_orb_slam_tpu_torch.ops.covariance import keypoint_covariance
    from sp_orb_slam_tpu_torch.ops.nms import greedy_grid_nms

    (score, cand, cvalid, heat_inv, uv, valid), ex = frontend_maps(
        state, dev, frames)
    n = score.shape[0]

    def nms(nb):
        return cuda_nms.batched_grid_nms(score[:nb], cand[:nb], cvalid[:nb],
                                         dist=ex.nms_dist, iters=ex.nms_iters)

    def cov(nb):
        return cuda_cov.batched_covariance(
            heat_inv[:nb], uv[:nb], valid[:nb], radius=ex.cov_window,
            iters=ex.cov_iters)

    def times(call):
        return " ".join(f"B={nb} {device_ms(lambda: call(nb)):.4f}"
                        for nb in (1, B))

    if "nms" in names:
        nms_agrees(f"nms on {n} frames of the SLAM room", score, cand,
                   cvalid, ex.nms_dist, ex.nms_iters,
                   batches=NMS_BATCHES[:-1] + (n,))
        r = rounds_needed(
            lambda k: greedy_grid_nms(score, cand, cvalid, dist=ex.nms_dist,
                                      iters=k),
            lambda a, b: (a == b).flatten(1).all(1)).cpu().numpy()
        log(f"nms on {n} frames of the SLAM room: rounds until the kept "
            f"mask stops changing, per image: max {r.max()} median "
            f"{np.median(r)} (iters {ex.nms_iters}, "
            f"{int((r > ex.nms_iters).sum())} images above); device ms "
            f"{times(nms)}")
    if "cov" in names:
        c_k, ci_k, r_k = cov(n)
        c_p, ci_p, r_p = keypoint_covariance(heat_inv, uv, valid,
                                             radius=ex.cov_window,
                                             iters=ex.cov_iters)
        err = float((c_k - c_p).abs().max())
        resp_equal = bool(torch.equal(r_k, r_p))
        r = rounds_needed(
            lambda k: keypoint_covariance(heat_inv, uv, valid,
                                          radius=ex.cov_window, iters=k)[0],
            lambda a, b: (a == b).all(-1))[valid].cpu().numpy()
        log(f"cov on {n} frames of the SLAM room ({int(valid.sum())} "
            f"keypoints): cov2 max_abs_err {err:.3e}, response equal "
            f"{resp_equal}; rounds until cov2 stops changing, per keypoint: "
            f"max {r.max()} median {np.median(r)} (iters {ex.cov_iters}, "
            f"{int((r > ex.cov_iters).sum())} keypoints above); device ms "
            f"{times(cov)}")
        if err > 1e-5 or not resp_equal:
            raise AssertionError("cov disagrees with its plain version on "
                                 "the frontend's outputs")


# ---------------------------------------------------------------- phase 3

FRONTEND_KERNELS = ("pair1", "nms", "cov", "match", "desc_sparse")
SLAM_KERNELS = ("nms", "cov", "match", "desc_sparse")


def zero_launches():
    from sp_orb_slam_tpu_torch.ops import _build

    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def read_launches(path, expected):
    """The counters after a path, which must have launched every kernel in
    `expected`."""
    from sp_orb_slam_tpu_torch.ops import _build

    launches = dict(_build.LAUNCHES)
    log(f"{path} launches: {launches}")
    missing = [k for k in expected if launches[k] < 1]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return launches


def _project(Twc, Kc, X):
    import numpy as np

    R, t = Twc[:3, :3], Twc[:3, 3]
    Xc = (X - t[None, :]) @ R
    z = Xc[:, 2]
    return (np.stack([Kc[0] * Xc[:, 0] / z + Kc[2],
                      Kc[1] * Xc[:, 1] / z + Kc[3]], -1), z > 0.1)


def gates(tag, feats, m12, ds, fa, fb):
    """The ray-cast gates of tests/test_trained_weights.py."""
    import numpy as np

    uv = feats.uv.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    midx = m12[0].cpu().numpy()
    na, nb = int(valid[0].sum()), int(valid[1].sum())
    sel = midx >= 0
    X, hit = ds.raycast(fa.gt_pose, uv[0])
    uvb, infront = _project(fb.gt_pose, ds.K, X)
    err = np.linalg.norm(uvb - uv[1][np.maximum(midx, 0)], axis=-1)
    correct = sel & hit & infront & (err < 3.0)
    prec = correct.sum() / max(sel.sum(), 1)
    log(f"{tag}: keypoints {na} / {nb}, init matches {int(sel.sum())}, "
        f"within 3 px of the ray cast {prec:.4f}")
    if not (na > 150 and nb > 150 and sel.sum() > 60 and prec > 0.9):
        raise AssertionError(f"{tag}: main-path gates failed")


def match_pair(feats):
    """Frame 0 -> frame 2 of a two-image batch, as match_init_batch takes
    them."""
    return (feats.desc[:1], feats.valid[:1], feats.uv[:1],
            feats.desc[1:], feats.uv[1:], feats.valid[1:])


def extract_and_match(cfg, state, dev, images):
    """`make_extractor(cfg, state, device=dev)` on the two images, then the
    init matcher kernel from the first to the second."""
    import torch

    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.ops import cuda_match

    feats = make_extractor(cfg, state, device=dev)(images)
    m12, _, _ = cuda_match.match_init_batch(*match_pair(feats), window=100,
                                            ratio=0.9)
    torch.cuda.synchronize()
    return feats, m12


def main_path(state, dev):
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.ops.matching import init_match

    cfg = Config()
    ds = RenderedDataset(cfg, seed=0, noise_seed=0)
    fa, fb = ds.frame(0), ds.frame(2)
    images = np.stack([fa.image, fb.image]).astype(np.float32) / 255.0

    def run(cfg_x):
        return extract_and_match(cfg_x, state, dev, images)

    bf = dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, dtype="bfloat16"))
    zero_launches()
    feats, m12 = run(bf)
    launches = read_launches("frontend (bf16)", FRONTEND_KERNELS)
    gates("bf16 kernels", feats, m12, ds, fa, fb)
    # the other first-pair kernel, on request: conv_packing="pair1t"
    bf_t = dataclasses.replace(bf, extractor=dataclasses.replace(
        bf.extractor, conv_packing="pair1t"))
    zero_launches()
    feats_t, m12_t = run(bf_t)
    pair1t_route = read_launches("frontend (bf16, conv_packing=pair1t)",
                                 ("pair1t",) + FRONTEND_KERNELS[1:])
    gates("bf16 kernels, pair1t", feats_t, m12_t, ds, fa, fb)

    # float32: kernels (auto on the card) vs the plain versions, and the
    # plain init matcher vs the kernel on the same features
    f_k, m_k = run(cfg)
    plain = dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, nms_method="xla", cov_method="windowed",
        desc_method="gather"))
    run_p = make_extractor(plain, state, device=dev)
    f_p = run_p(images)
    m_p, _, _ = init_match(*match_pair(f_k), window=100, ratio=0.9)
    torch.cuda.synchronize()
    gates("f32 kernels", f_k, m_k, ds, fa, fb)
    same_uv = torch.equal(f_k.uv, f_p.uv) and torch.equal(f_k.count,
                                                          f_p.count)
    cov_err = float((f_k.cov2 - f_p.cov2).abs().max())
    desc_err = float((f_k.desc - f_p.desc).abs().max())
    bad, excused = match_disagreements(match_pair(f_k), m_k, m_p)
    log(f"f32 kernels vs plain: uv/count identical {same_uv}, "
        f"cov2 max_abs_err {cov_err:.3e}, desc max_abs_err {desc_err:.3e}, "
        f"counts {f_k.count.tolist()}, match12 rows differing {len(bad)} "
        f"({excused} near-ties)")
    if (not same_uv or cov_err > 1e-5 or desc_err > 1e-5
            or excused != len(bad)):
        raise AssertionError("f32 main path: kernels and plain disagree")

    # the descriptor routes of the f32 extractor against "gather"
    routes = {}
    for method in ("pallas_sparse", "pallas"):
        cfg_m = dataclasses.replace(cfg, extractor=dataclasses.replace(
            cfg.extractor, desc_method=method))
        run_m = make_extractor(cfg_m, state, device=dev)
        zero_launches()
        f_m = run_m(images)
        torch.cuda.synchronize()
        routes[method] = read_launches(
            f"frontend desc_method={method}",
            ("desc_sparse",) if method == "pallas_sparse" else ("desc_dense",))
        same = torch.equal(f_m.uv, f_p.uv) and torch.equal(f_m.count,
                                                           f_p.count)
        err = float((f_m.desc - f_p.desc).abs().max())
        log(f"desc_method={method} vs gather: uv/count identical {same}, "
            f"desc max_abs_err {err:.3e}")
        if not same or err > 1e-5:
            raise AssertionError(f"desc_method={method} disagrees with gather")
    cov_routes(state, dev, images, f_k)
    return launches, pair1t_route, routes["pallas"]


def cov_routes(state, dev, images, f_k):
    """The float32 extractor's plain covariance routes beside the cov
    kernel's features `f_k` of the same frames: cov_method="dense" (the
    JAX package's dense-ownership fill; tests/test_extractor.py:245-277's
    gates: the same responses, median relative cov2 difference < 0.1,
    cov2 >= 1) and "none" (unit covariance, zero response); neither
    launches the cov kernel."""
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import make_extractor

    cfg = Config()
    valid = f_k.valid
    for method in ("dense", "none"):
        run_m = make_extractor(dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor,
                                               cov_method=method)),
            state, device=dev)
        zero_launches()
        f_m = run_m(images)
        torch.cuda.synchronize()
        launches = read_launches(f"frontend cov_method={method}",
                                 ("nms", "desc_sparse"))
        same = torch.equal(f_m.uv, f_k.uv) and torch.equal(f_m.count,
                                                           f_k.count)
        if method == "dense":
            resp_err = float((f_m.response - f_k.response).abs().max())
            rel = ((f_m.cov2 - f_k.cov2).abs() / f_k.cov2)[valid]
            med = float(rel.median())
            ok = (same and resp_err <= 1e-6 and med < 0.1
                  and bool((f_m.cov2 >= 1.0).all()))
            log(f"cov_method=dense vs cuda: uv/count identical {same}, "
                f"response max_abs_err {resp_err:.3e}, cov2 median relative "
                f"difference {med:.4f} (max {float(rel.max()):.4f}), cov2 "
                f"min {float(f_m.cov2.min()):.4f}, cov launches "
                f"{launches['cov']}")
        else:
            ok = (same and bool((f_m.cov2 == 1.0).all())
                  and bool((f_m.cov2_inv == 1.0).all())
                  and bool((f_m.response == 0.0).all()))
            log(f"cov_method=none: uv/count identical {same}, unit cov2 and "
                f"cov2_inv, zero response {ok}, cov launches "
                f"{launches['cov']}")
        if not ok or launches["cov"] != 0:
            raise AssertionError(f"cov_method={method}: gates failed")


# SuperPoint forward configurations timed at B=32, 752x480: (compute dtype,
# conv_packing)
FORWARD_ROUTES = (("float32", "none"), ("bfloat16", "none"),
                  ("bfloat16", "pair1"), ("bfloat16", "pair1t"))
FORWARD_ROUNDS, FORWARD_ITERS = 3, 5
# the first three conv pairs with the first S2D_DEPTHS of them on the 2x2
# space-to-depth layout (the JAX package's conv_packing "s2d", "s2d2",
# "s2d3", which the port runs as "none"), timed against depth 0; in float32
# the packed pairs' output within S2D_F32_RTOL of max |unpacked| (an exact
# repacking: only cuDNN's summation order differs)
S2D_DEPTHS = (1, 2, 3)
S2D_F32_RTOL = 1e-5


def room_pair(frames):
    """Frames 0 and 2 of the held-out room 5 (`frames`, rendered up front
    for phase 6), its dataset for the ray cast, and the two images in
    [0, 1]."""
    import numpy as np

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset

    ds = RenderedDataset(Config(), n_frames=SLAM_FRAMES, seed=5,
                         noise_seed=0)
    fa, fb = frames[0], frames[2]
    return ds, fa, fb, np.stack([fa.image, fb.image]).astype(
        np.float32) / 255.0


def with_extractor(cfg, **kw):
    return dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, **kw))


def pack_conv(w, b):
    """The JAX package's `_pack_conv`: one 3x3 `same` conv, HWIO (3, 3,
    Cin, Cout), as the exact conv on the 2x2 space-to-depth layout, HWIO
    (3, 3, 4 Cin, 4 Cout); sub-position s = 2 dy + dx leads the packed
    channel index.  Tap (dy, dx) of output sub-position (a, c) lands on
    packed offset ((a+dy)//2, (c+dx)//2) and input sub-position
    ((a+dy)%2, (c+dx)%2)."""
    import numpy as np

    cin, cout = w.shape[2:]
    wp = np.zeros((3, 3, 4 * cin, 4 * cout), w.dtype)
    for a in (0, 1):
        for c in (0, 1):
            so = 2 * a + c
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    si = 2 * ((a + dy) % 2) + (c + dx) % 2
                    wp[(a + dy) // 2 + 1, (c + dx) // 2 + 1,
                       si * cin:(si + 1) * cin,
                       so * cout:(so + 1) * cout] += w[dy + 1, dx + 1]
    return wp, np.tile(b, 4)


def conv_pairs(model, x, depth, packed):
    """SuperPoint's first three conv pairs and pools on x (B, 1, H, W,
    channels-last, in the compute dtype), the first `depth` of them on the
    space-to-depth layout with `packed` {name: (OIHW weight, bias)}: conv,
    conv, then the max over the 4 sub-position groups (the pair's pool)."""
    import torch
    import torch.nn.functional as F

    from sp_orb_slam_tpu_torch.models.superpoint import PAIRS

    for i, (na, nb) in enumerate(PAIRS):
        if i < depth:
            n, c, h, w = x.shape
            xp = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(
                0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)
            xp = xp.contiguous(memory_format=torch.channels_last)
            xp = model._conv_wb(model._conv_wb(xp, *packed[na]), *packed[nb])
            n, c, h, w = xp.shape
            x = xp.view(n, 4, c // 4, h, w).amax(1).contiguous(
                memory_format=torch.channels_last)
        else:
            x = F.max_pool2d(model._conv(model._conv(x, na), nb), 2)
    return x


def s2d_pairs(state, dev, smi, frames):
    """The JAX package's space-to-depth lowerings, measured: the first
    three conv pairs with the first 1, 2 or 3 on the packed layout
    (`pack_conv`), against all three unpacked (the route the port runs for
    every conv_packing "s2d*").  In float32 on frames 0 and 2 of room 5
    the packed output within S2D_F32_RTOL of max |unpacked| (bfloat16's is
    printed); then both timed at B=32, 752x480 in turns (CUDA events)."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.models.superpoint import PAIRS, SuperPoint
    from sp_orb_slam_tpu_torch.utils.precision import full_f32

    model = SuperPoint({k: v.to(dev) for k, v in state.items()}).eval()
    packed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name in sum(PAIRS, ()):
            m = getattr(model, name)
            wp, bp = pack_conv(
                m.weight.detach().cpu().permute(2, 3, 1, 0).numpy(),
                m.bias.detach().cpu().numpy())
            packed[dtype, name] = (
                torch.from_numpy(wp).permute(3, 2, 0, 1).to(
                    dev, dtype, memory_format=torch.channels_last),
                torch.from_numpy(bp).to(dev, dtype))

    def run(x, depth):
        with torch.inference_mode(), full_f32():
            w = {n: packed[x.dtype, n] for n in sum(PAIRS, ())}
            return conv_pairs(model, x, depth, w)

    def inputs(images, dtype):
        return torch.as_tensor(images, device=dev)[:, None].to(
            dtype).contiguous(memory_format=torch.channels_last)

    images = room_pair(frames)[3]
    for dtype in (torch.float32, torch.bfloat16):
        x = inputs(images, dtype)
        ref = run(x, 0).float()
        for d in S2D_DEPTHS:
            err = float((run(x, d).float() - ref).abs().max()
                        / ref.abs().max())
            log(f"{dtype} first 3 pairs, {d} packed vs none: max|diff| / "
                f"max|none| {err:.3e}")
            if dtype == torch.float32 and not err <= S2D_F32_RTOL:
                raise AssertionError(f"s2d depth {d} disagrees with none")
    x32 = np.random.default_rng(0).random((B, H, W), np.float32)
    xs = {dt: inputs(x32, dt) for dt in (torch.float32, torch.bfloat16)}
    times = {(dt, d): [] for dt in xs for d in (0,) + S2D_DEPTHS}
    for _ in range(FORWARD_ROUNDS):
        for dt, d in times:
            times[dt, d].append(cuda_ms(lambda: run(xs[dt], d),
                                        iters=FORWARD_ITERS, warmup=1))
    lines = [f"first 3 conv pairs, B={B} {W}x{H}, the first d on the "
             f"space-to-depth layout, ms a call (CUDA events, "
             f"{FORWARD_ITERS} calls, {FORWARD_ROUNDS} rounds in turns: "
             f"median [min, max]) | {smi}"]
    for (dt, d), ts in times.items():
        med, base = np.median(ts), np.median(times[dt, 0])
        lines.append(f"  {str(dt)[6:]:<8} d={d} {med:9.3f} [{min(ts):.3f}, "
                     f"{max(ts):.3f}]  x{med / base:.3f} of d=0")
    log("\n".join(lines + forward_times(state, dev, smi)))


def forward_times(state, dev, smi):
    """The SuperPoint forward alone (no heat maps) at B=32, 752x480 for
    each of FORWARD_ROUTES, CUDA events over FORWARD_ITERS back-to-back
    calls, the routes taken in turns FORWARD_ROUNDS times.  Returns the
    lines to print."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint

    model = SuperPoint({k: v.to(dev) for k, v in state.items()}).eval()
    x = torch.as_tensor(np.random.default_rng(0).random((B, H, W),
                                                        np.float32),
                        device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def call(dtype, packing):
        with torch.inference_mode():
            model(x, conv_packing=packing, with_heat=False,
                  with_heat_inv=False, compute_dtype=dtypes[dtype])

    times = {r: [] for r in FORWARD_ROUTES}
    for _ in range(FORWARD_ROUNDS):
        for r in FORWARD_ROUTES:
            times[r].append(cuda_ms(lambda: call(*r), iters=FORWARD_ITERS,
                                    warmup=1))
    lines = [f"SuperPoint forward alone, B={B} {W}x{H}, ms a call (CUDA "
             f"events, {FORWARD_ITERS} calls, {FORWARD_ROUNDS} rounds in "
             f"turns: median [min, max]) | {smi}"]
    for (dtype, p), ts in times.items():
        med, base = np.median(ts), np.median(times[dtype, "none"])
        lines.append(f"  {dtype:<8} {p:<6} {med:9.3f} [{min(ts):.3f}, "
                     f"{max(ts):.3f}]  x{med / base:.3f} of {dtype} none")
    return lines


# ---------------------------------------------------------------- phase 4


def make_step(state, dev):
    """bench.py's step: extract (bf16, B images) + init match against the
    previous batch.  Returns step(carry) -> carry = (feats, n); carry None
    starts from bench.py's random previous batch."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import extract
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint, unit_rows
    from sp_orb_slam_tpu_torch.ops import cuda_match

    cfg = Config()
    ex = cfg.extractor
    model = SuperPoint({k: v.to(dev) for k, v in state.items()}).eval()
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((B, H, W), np.float32), device=dev)
    pdesc = unit_rows(torch.as_tensor(rng.random((B, K, 256), np.float32),
                                      device=dev))
    puv = torch.as_tensor(rng.random((B, K, 2), np.float32) * 400,
                          device=dev)
    pvalid = torch.ones((B, K), dtype=torch.bool, device=dev)

    def step(carry):
        prev = (pdesc, puv, pvalid) if carry is None else (
            carry[0].desc, carry[0].uv, carry[0].valid)
        with torch.inference_mode():
            feats = extract(
                model, images, num_features=cfg.tracking.num_features,
                max_keypoints=cfg.runtime.max_keypoints,
                conf_thresh=ex.conf_thresh, nms_dist=ex.nms_dist,
                border=ex.border, nms_iters=ex.nms_iters,
                cov_radius=ex.cov_window, cov_iters=ex.cov_iters,
                with_heat_inv=False, compute_dtype=torch.bfloat16)
            _, n, _ = cuda_match.match_init_batch(
                prev[0], prev[2], prev[1], feats.desc, feats.uv,
                feats.valid, window=100, ratio=0.9)
        return feats, n

    return step


def step_fps(step):
    """frames/s of the bench step: B frames x 50 steps over the wall time of
    5 blocks of 10 steps (one synchronize at the end), after 5 warm-up
    steps.  CUDA events between the blocks give each block's time per step
    on the device clock, as the spread.  Returns (stats, carry)."""
    import torch

    carry = step(None)
    for _ in range(4):
        carry = step(carry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(STEP_BLOCKS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for m in marks[1:]:
        for _ in range(STEP_BLOCK):
            carry = step(carry)
        m.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = STEP_BLOCKS * STEP_BLOCK
    blocks = [a.elapsed_time(b) / STEP_BLOCK for a, b in zip(marks, marks[1:])]
    return dict(batch=B, steps=steps, step_ms=wall * 1e3 / steps,
                fps=steps * B / wall, block_step_ms_min=min(blocks),
                block_step_ms_max=max(blocks),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                matches_last=int(carry[1].sum())), carry


# ---------------------------------------------------------------- phase 5

# kernel-name fragments -> the source (csrc/<name>.cu) or the library that
# launches them; a kernel falls in the first group one of whose fragments
# its name holds, else in OTHER
GROUPS = (
    ("pair1", ("pair1_kernel",)),
    ("pair1t", ("pair1t_kernel", "pair1t_row_product_kernel")),
    ("match", ("match_tile_kernel", "match_merge_kernel",
               "match_finalize_kernel")),
    ("nms", ("nms_kernel",)),
    ("cov", ("cov_kernel",)),
    ("desc_sparse", ("desc_sparse_kernel",)),
    ("desc_dense", ("desc_dense_kernel",)),
    ("noop", ("noop_kernel",)),
    ("cuDNN / cuBLAS", ("xmma", "cutlass", "nvjet", "cudnn", "gemm")),
)
OTHER = "other PyTorch kernels"


def group_of(kernel_name):
    return next((g for g, keys in GROUPS
                 if any(k in kernel_name for k in keys)), OTHER)


def profile_step(step, carry):
    """The bench step under torch.profiler for PROFILE_STEPS steps: wall
    time, the device's idle share (1 - summed device time / wall time),
    device time per step of each layer's kernels, then of each kernel name
    with its share of the step and its calls per step.  Device-side events
    only: a CPU operator's row repeats the time of the kernels it
    launched.  Returns the lines to print."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            carry = step(carry)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = event_device_us(ev)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / PROFILE_STEPS,
                         ev.count // PROFILE_STEPS, ev.key))
    if not rows:
        raise AssertionError("profiler: no device time recorded")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {}
    for ms, _, name in rows:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
    lines = [f"profile: batch {B} | {PROFILE_STEPS} steps | wall "
             f"{wall_ms:.3f} ms/step | device busy {busy:.3f} ms/step | "
             f"idle share {1 - busy / wall_ms:.3f} | "
             f"{len(rows)} kernel names, {sum(r[1] for r in rows)} "
             f"launches/step"]
    lines += [f"{ms:9.3f} {ms / wall_ms:6.3f}        [{g}]"
              for g, ms in sorted(groups.items(), key=lambda x: -x[1])]
    lines += [f"{'ms/step':>9} {'share':>6} {'calls':>5}  kernel"]
    lines += [f"{ms:9.3f} {ms / wall_ms:6.3f} {n:5d}  {name[:100]}"
              for ms, n, name in rows[:PROFILE_ROWS]]
    return lines


# ---------------------------------------------------------------- phase 6

SLAM_FRAMES = 220     # room 5's frames (phases 8 and 9 spin them all)
OFFLINE_FRAMES = 120  # phase 6: the first of them (cut from 220 for the
#                       time limit when phase 13 came)
PROFILE_FRAMES = 1    # the spin's last frames, profiled apart from the rest
#                       (3 until phase 9 came: its post-processing costs
#                       ~18 s a frame)
SLAM_ROWS = 12        # kernel and CPU-op rows printed
# the profiler's names for the kernels the SLAM path launches once a frame
IN_PATH = (("nms", "nms_kernel"), ("cov", "cov_kernel"),
           ("desc_sparse", "desc_sparse_kernel"))


def timer_ms(timer):
    """{tag: every sample the `Timer` kept, in ms}."""
    return {tag: [dt * 1e3 for dt in v] for tag, v in timer.samples().items()}


def time_process(sys_):
    """Wrap `sys_.process` to append each frame's wall ms to the returned
    list."""
    process = sys_.process
    per_frame = []

    def timed_process(raw):
        t0 = time.perf_counter()
        process(raw)
        per_frame.append((time.perf_counter() - t0) * 1e3)

    sys_.process = timed_process
    return per_frame


def replay_check(sys_, cfg, state, dev, raw):
    """System's extractor closure replays its captured graph: it replayed
    during the spin, and one more replay (the frame `raw`, as System hands
    it in) is bit-equal in every field to the module's eager `extract` on
    the same image, with each of its hand-written kernels in IN_PATH seen
    by the profiler as device events as often as the replay counted it in
    `_build.LAUNCHES`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sp_orb_slam_tpu_torch.extractor import (Features, extract,
                                                 extract_options)
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.ops import _build

    run = sys_._extract
    spun = dict(run.calls)
    if spun.get("replay", 0) < 1:
        raise AssertionError(f"SLAM: the extractor never replayed: {spun}")
    images = []

    def keep_input(x):
        images.append(x)
        return run(x)

    sys_._extract = keep_input
    before = dict(_build.LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = sys_._dispatch_extract(raw)
            torch.cuda.synchronize()
    finally:
        sys_._extract = run
    counted = {k: n - before[k] for k, n in _build.LAUNCHES.items()
               if n != before[k]}
    seen = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for name, prefix in IN_PATH:
                if short_name(ev.key).startswith(prefix):
                    seen[name] = seen.get(name, 0) + ev.count
    model = SuperPoint(state).to(dev).eval()
    with torch.inference_mode():
        want = extract(model, images[0], **extract_options(cfg))
    torch.cuda.synchronize()
    def bits(t):
        return t.reshape(-1).contiguous().view(torch.uint8)

    differ = [f for f, a, b in zip(Features._fields, got, want)
              if (a is None) != (b is None) or a is not None and not (
                  a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(bits(a), bits(b)))]
    log(f"SLAM replay: calls after the spin {spun}, then "
        f"{dict(run.calls)}; the replay's launches {counted}, its kernels "
        f"seen by the profiler {seen}; fields not bit-equal to the eager "
        f"extract: {differ}")
    if run.calls["replay"] != spun["replay"] + 1:
        raise AssertionError("SLAM: the checked call did not replay")
    if differ:
        raise AssertionError(f"SLAM: replay differs from extract in {differ}")
    if counted != {name: 1 for name, _ in IN_PATH} or seen != counted:
        raise AssertionError(f"SLAM: the replay counted {counted} launches, "
                             f"the profiler saw {seen}")


def slam_phase(state, dev, smi, frames):
    """The offline SLAM path on the card over the first OFFLINE_FRAMES
    frames of the held-out rendered room (texture seed 5), then the gates.
    One System spins the first OFFLINE_FRAMES - PROFILE_FRAMES frames with
    no profiler and no synchronize
    of its own (the pipeline's readbacks are its only waits): the per-frame
    wall time of `System.process` and the `Timer` spans come from that
    spin.  The same System then spins the last PROFILE_FRAMES frames under
    torch.profiler, with one synchronize before and after, for the device's
    idle share of that window."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = Config()
    ds = RenderedDataset(cfg, n_frames=SLAM_FRAMES, seed=5, noise_seed=0)
    sys_ = System(cfg, params=state, device=dev)
    per_frame = time_process(sys_)
    n_timed = OFFLINE_FRAMES - PROFILE_FRAMES
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.spin(frames[:n_timed])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pf = np.asarray(per_frame)
    timed_spans = {k: np.asarray(v) for k, v in timer_ms(sys_.timer).items()}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        sys_.spin(frames[n_timed:OFFLINE_FRAMES])
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t1) * 1e3
    launches = read_launches("SLAM", SLAM_KERNELS)
    replay_check(sys_, cfg, state, dev, frames[OFFLINE_FRAMES - 1])

    rep = sys_.report()
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    kern, ops = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kern.append((event_device_us(ev) / 1e3 / PROFILE_FRAMES,
                ev.count / PROFILE_FRAMES, ev.key))
        elif ev.device_type == DeviceType.CPU:
            ops.append((ev.self_cpu_time_total / 1e3 / PROFILE_FRAMES,
                        ev.count / PROFILE_FRAMES, ev.key))
    kern.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(k[0] for k in kern) * PROFILE_FRAMES
    n_kern = sum(k[1] for k in kern)
    # each kernel's device ms a launch as the path runs it: its inputs as
    # the preceding kernels left them in L2 (phase 2 times it cold)
    in_path = {}
    for ms, n, key in kern:
        for name, prefix in IN_PATH:
            if short_name(key).startswith(prefix):
                t, c = in_path.get(name, (0.0, 0.0))
                in_path[name] = (t + ms, c + n)
    in_path = {k: t / c for k, (t, c) in in_path.items()}
    lines = [f"SLAM: {OFFLINE_FRAMES} frames of the rendered room (seed 5) at "
             f"{cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype} | {smi}",
             f"SLAM: unprofiled spin of frames 0-{n_timed - 1}: wall "
             f"{wall:.3f} s, {wall * 1e3 / n_timed:.2f} ms/frame | "
             f"System.process ms/frame median {np.median(pf):.2f} p90 "
             f"{np.percentile(pf, 90):.2f} mean {pf.mean():.2f} max "
             f"{pf.max():.2f} | {smi}"]
    for tag in ("tracking/frame", "tracking/total", "mapping"):
        v = timed_spans.get(tag, np.zeros(1))
        lines.append(f"SLAM span {tag}: median {np.median(v):.2f} p90 "
                     f"{np.percentile(v, 90):.2f} mean {v.mean():.2f} max "
                     f"{v.max():.2f} ms (n={len(v)}) | {smi}")
    # no floor on the idle share: a device sum above the wall time shows
    lines.append(f"SLAM profile: frames {n_timed}-{OFFLINE_FRAMES - 1} | wall "
                 f"{win_ms / PROFILE_FRAMES:.2f} ms/frame (profiler on) | "
                 f"device busy {busy / PROFILE_FRAMES:.2f} ms/frame | idle "
                 f"share {1 - busy / win_ms:.3f} | "
                 f"{n_kern:.0f} device events/frame | {smi}")
    lines.append(f"{'ms/frame':>9} {'calls':>7}  kernel (top {SLAM_ROWS})")
    lines += [f"{ms:9.3f} {n:7.0f}  {k[:100]}" for ms, n, k in
              kern[:SLAM_ROWS]]
    lines.append("SLAM profile, the port's kernels in the path, device ms a "
                 "launch: " + ", ".join(
                     f"{k} {in_path[k]:.4f}" if k in in_path else
                     f"{k} not among the profiled events" for k, _ in IN_PATH))
    lines.append(f"{'ms/frame':>9} {'calls':>7}  CPU op, self time "
                 f"(top {SLAM_ROWS})")
    lines += [f"{ms:9.3f} {n:7.0f}  {k[:100]}" for ms, n, k in
              ops[:SLAM_ROWS]]
    lines.append(f"SLAM result: {json.dumps(rep, default=float)} | ATE "
                 f"rmse {ate.rmse:.4f} mean {ate.mean:.4f} over "
                 f"{ate.n_pairs} frames | {smi}")
    log("\n".join(lines))
    if not (rep["n_lost"] == 0 and rep["n_frames"] >= 0.8 * OFFLINE_FRAMES
            and ate.rmse < 0.2):
        raise AssertionError("SLAM gates failed (0 LOST, >= 80 % tracked, "
                             "ATE rmse < 0.2)")
    if launches["desc_sparse"] != OFFLINE_FRAMES:
        raise AssertionError(f"desc_sparse launched "
                             f"{launches['desc_sparse']} times for "
                             f"{OFFLINE_FRAMES} frames")
    first = dict(wall_ms=wall * 1e3 / n_timed, spans=timed_spans,
                 process=pf, in_path=in_path)
    return launches, float(ate.rmse), first


# ---------------------------------------------------------------- phase 8

LOOP_KERNELS = ("nms", "cov", "desc_sparse")  # once a frame; match >= 1
LOOP_SLOW_MS = 100.0  # loop spans printed one by one
# the loop closer's stages timed apart (the essential graph runs inside
# the correction, global BA after it)
LOOP_STAGES = ("_detect", "_compute_sim3", "_correct_loop_locked",
               "_essential_graph", "_run_gba")


def span_line(tag, v, smi):
    import numpy as np

    return (f"{tag}: median {np.median(v):.2f} p90 "
            f"{np.percentile(v, 90):.2f} max {np.max(v):.2f} ms (n={len(v)})"
            f" | {smi}")


def loop_phase(state, dev, smi, frames, ate_off):
    """SLAM with loop closing on the card: a System with `use_loop` and
    the fitted NetVLAD checkpoint spins room 5's 220 rendered frames (the
    JAX package closes its loop on them), with no profiler and
    no synchronize of its own; then the gates: a loop closed, 0 LOST,
    >= 80 % tracked, ATE < 0.2, the SLAM kernels launched as the frames
    ask.  `ate_off` is phase 6's ATE without loop closing, over its first
    OFFLINE_FRAMES frames."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = _merge_dataclass(Config(), {"use_loop": True, "loop": {
        "use_loop": True,
        "netvlad_weights": os.path.join(HERE, "weights",
                                        "vlad_rendered.npz")}})
    ds = RenderedDataset(cfg, n_frames=SLAM_FRAMES, seed=5, noise_seed=0)
    sys_ = System(cfg, params=state, device=dev)
    process = sys_.process
    per_frame, events = [], []

    def timed_process(raw):
        n0 = sys_.looper.n_loops_closed
        t0 = time.perf_counter()
        process(raw)
        per_frame.append((time.perf_counter() - t0) * 1e3)
        if sys_.looper.n_loops_closed > n0:
            events.append((len(per_frame) - 1,
                           sys_.timer.tags["loop"].samples[-1] * 1e3))

    sys_.process = timed_process
    # the loop closer's stages, timed on the host by frame (each ends in a
    # readback, so its wall time holds its device work)
    stage_ms = {}

    def timed_stage(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                key = (len(per_frame), name)
                stage_ms[key] = (stage_ms.get(key, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
        return run

    for name in LOOP_STAGES:
        setattr(sys_.looper, name, timed_stage(name,
                                               getattr(sys_.looper, name)))
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.spin(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("SLAM + loop", SLAM_KERNELS)
    spans = timer_ms(sys_.timer)

    rep = sys_.report()
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    pf = np.asarray(per_frame)
    lines = [f"SLAM + loop: {len(frames)} frames of the rendered room (seed "
             f"5) at {cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype}, NetVLAD "
             f"weights/vlad_rendered.npz | {smi}",
             f"SLAM + loop: wall {wall:.3f} s, "
             f"{wall * 1e3 / len(frames):.2f} ms/frame | "
             + span_line("System.process ms/frame", pf, smi)]
    for tag in ("tracking/frame", "tracking/total", "mapping", "loop"):
        lines.append(span_line(f"SLAM + loop span {tag}",
                               spans.get(tag, [0.0]), smi))
    # every frame whose loop span is long: the loop events, and detections
    # whose Sim3 attempts found no loop
    closed = {frame for frame, _ in events}
    for frame, ms in enumerate(spans["loop"]):
        if ms >= LOOP_SLOW_MS or frame in closed:
            what = "loop closed" if frame in closed else "no loop"
            parts = ", ".join(f"{name.strip('_')} "
                              f"{stage_ms.get((frame, name), 0.0):.2f}"
                              for name in LOOP_STAGES)
            lines.append(f"SLAM + loop: frame {frame} ({what}): loop span "
                         f"{ms:.2f} ms ({parts} ms), System.process "
                         f"{pf[frame]:.2f} ms | {smi}")
    lines.append(f"SLAM + loop: loops (current KF, matched KF) "
                 f"{sys_.looper.loops} | {smi}")
    lines.append(f"SLAM + loop result: {json.dumps(rep, default=float)} | "
                 f"ATE rmse {ate.rmse:.4f} mean {ate.mean:.4f} over "
                 f"{ate.n_pairs} frames, loop closing off (phase 6, its "
                 f"{OFFLINE_FRAMES} frames) {ate_off:.4f} | {smi}")
    log("\n".join(lines))
    if not (rep["n_loops_closed"] >= 1 and rep["n_lost"] == 0
            and rep["n_frames"] >= 0.8 * len(frames) and ate.rmse < 0.2):
        raise AssertionError("SLAM + loop gates failed (a loop closed, 0 "
                             "LOST, >= 80 % tracked, ATE rmse < 0.2)")
    wrong = {k: launches[k] for k in LOOP_KERNELS
             if launches[k] != len(frames)}
    if wrong or launches["match"] < 1:
        raise AssertionError(f"SLAM + loop launches for {len(frames)} "
                             f"frames: {launches}")
    return launches, float(ate.rmse)


# ---------------------------------------------------------------- phase 9

ONLINE_KERNELS = ("nms", "cov", "desc_sparse")  # once a frame after warmup
ONLINE_TRACKED = 176  # frames tracked of SLAM_FRAMES (phase 6's 80 % gate)
ONLINE_WAIT = 120.0   # seconds any wait of the phase may take
# the TrackingKernels stages a run may call (tests/test_torch_warmup.py)
STAGES = ("gather_rows", "dust_track", "dust_track_batch", "heat_track",
          "fused_track",
          "motion_track", "motion_track_batch", "ref_track", "reloc_track",
          "reloc_track_batch", "local_map_track", "local_map_track_wide",
          "local_map_track_batch", "init_two_view", "triangulate_pair_batch",
          "fuse", "fuse_batch", "fetch_features_host",
          "fetch_features_host_batch")


def spy_stages(kernels):
    """Wrap the stage methods of `kernels` to count each call by variant
    in the returned Counter: the stage, its window (`wide`) where it has
    one, and for the mapper's batches whether the rows ran unbatched."""
    import collections
    import functools

    seen = collections.Counter()
    for name in STAGES:
        fn = getattr(kernels, name)

        @functools.wraps(fn)
        def spy(*args, _name=name, _fn=fn, **kwargs):
            key = (_name, kwargs.get("wide", False))
            if _name in ("triangulate_pair_batch", "fuse_batch"):
                key = (_name, len(args[0]) == 1)
            seen[key] += 1
            return _fn(*args, **kwargs)

        setattr(kernels, name, spy)
    return seen


def timed_calls(obj, name, log_to):
    """Wrap `obj.name` to append (thread name, ms, start s) of each call to
    `log_to`; returns the original for restoring."""
    import threading

    fn = getattr(obj, name)

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log_to.append((threading.current_thread().name,
                           (time.perf_counter() - t0) * 1e3, t0))

    setattr(obj, name, run)
    return fn


def online_config():
    """Phase 8's configuration (defaults, `use_loop` with the fitted
    NetVLAD checkpoint) in the online mode."""
    from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass

    return _merge_dataclass(Config(), {"online": True, "use_loop": True,
                                       "loop": {
        "use_loop": True,
        "netvlad_weights": os.path.join(HERE, "weights",
                                        "vlad_rendered.npz")}})


def online_phase(state, dev, smi, frames, ate_off, ate_loop):
    """The online mode on the card: phase 8's System with mapping and loop
    closing on their own threads beside tracking, warmed up, spun over
    room 5's 220 frames from memory, then shut down (drained and joined).
    Where no loop closed, a forced leg runs the transient global BA over
    the online map on its own thread, the caller taking the map lock
    while it solves.  Returns the phase's numbers for `online_gates`.
    `ate_off` / `ate_loop`: phases 6 and 8's ATE (phase 6 over its
    OFFLINE_FRAMES frames)."""
    import threading

    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.slam import local_mapping as lm_mod
    from sp_orb_slam_tpu_torch.slam import loop_closing as lc_mod
    from sp_orb_slam_tpu_torch.slam.system import System

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = online_config()
    ds = RenderedDataset(cfg, n_frames=SLAM_FRAMES, seed=5, noise_seed=0)
    sys_ = System(cfg, params=state, device=dev)
    stages = spy_stages(sys_.kernels)
    sync()
    t0 = time.perf_counter()
    sys_.warmup()
    sync()
    warmup_s = time.perf_counter() - t0
    warmed = set(stages)
    stages.clear()

    # the backend's timings, wrapped from here (the package has no
    # instrumentation of its own): each keyframe's pipeline on the mapping
    # thread, each BA solve by thread, the GBA solve and its commit
    pipeline, solves, gba_solve, gba_commit = [], [], [], []
    timed_calls(sys_.mapper, "_pipeline", pipeline)
    real = {name: timed_calls(mod, name, log_to) for mod, name, log_to in (
        (lm_mod, "_solve_ba", solves),
        (lc_mod, "solve_global_ba", gba_solve),
        (lc_mod, "apply_global_ba_staged", gba_commit))}
    per_frame, frame_start, shutdown_s = [], [], []
    process, shutdown = sys_.process, sys_.shutdown

    def timed_process(raw):
        t1 = time.perf_counter()
        process(raw)
        per_frame.append((time.perf_counter() - t1) * 1e3)
        frame_start.append(t1)

    def timed_shutdown(*a, **kw):
        t1 = time.perf_counter()
        try:
            return shutdown(*a, **kw)
        finally:
            shutdown_s.append(time.perf_counter() - t1)

    sys_.process, sys_.shutdown = timed_process, timed_shutdown
    try:
        zero_launches()
        sync()
        t0 = time.perf_counter()
        sys_.spin(frames)  # ends with shutdown: drained and joined
        sync()
        wall = time.perf_counter() - t0
        from sp_orb_slam_tpu_torch.ops import _build

        launches = dict(_build.LAUNCHES)
        n_init = sum(n for (name, _), n in stages.items()
                     if name == "init_two_view")
        spun = set(stages)
        looper = sys_.looper
        loops = list(looper.loops)
        joined = {"mapping": sys_.mapper._thread is None,
                  "loop": looper._thread is None,
                  "global_ba": looper._gba_thread is None}
        queues = {"mapping": len(sys_.mapper.queue),
                  "loop": len(looper.queue)}
        errors = [repr(e) for e in (sys_.mapper.error, looper.error) if e]
        stamped = sum(kf.ba_global_for >= 0
                      for kf in sys_.map.keyframes.values() if not kf.bad)
        rep = sys_.report()
        ts, poses = sys_.trajectory()
        tg, pg = ds.gt_trajectory()
        ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
        forced = None
        if not any(c[0] == "global_ba" for c in gba_commit):
            forced = forced_gba(sys_, lc_mod, lc_mod.solve_global_ba)
    finally:
        for (mod, name), fn in zip(((lm_mod, "_solve_ba"),
                                    (lc_mod, "solve_global_ba"),
                                    (lc_mod, "apply_global_ba_staged")),
                                   real.values()):
            setattr(mod, name, fn)
    map_solves = [ms for name, ms, _ in solves if name == "local_mapping"]
    kf_ms = [ms for _, ms, _ in pipeline]
    pf = np.asarray(per_frame)
    # each frame's share of its time that the mapping thread spent inside
    # a keyframe's pipeline: the frames it fully overlaps against those it
    # does not touch (the GIL's share of tracking's time)
    busy = [(t0, t0 + ms / 1e3) for _, ms, t0 in pipeline]
    share = np.asarray([sum(max(0.0, min(t0 + ms / 1e3, b) - max(t0, a))
                            for a, b in busy) / max(ms / 1e3, 1e-9)
                        for t0, ms in zip(frame_start, per_frame)])
    idle, full = pf[share == 0.0], pf[share >= 0.999]
    lines = [f"online: {len(frames)} frames of the rendered room (seed 5) at "
             f"{cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype}, "
             f"use_loop, mapping and loop closing on their own threads | "
             f"{smi}",
             f"online: warmup {warmup_s:.3f} s | {smi}",
             f"online: wall {wall:.3f} s, {wall * 1e3 / len(frames):.2f} "
             f"ms/frame (drain and joins included) | "
             + span_line("System.process (tracking alone) ms/frame", pf, smi),
             f"online: first frame after warmup {pf[0]:.2f} ms | {smi}",
             span_line("online: mapping thread ms per keyframe (_pipeline)",
                       kf_ms or [0.0], smi),
             span_line("online: local BA solves on the mapping thread ms",
                       map_solves or [0.0], smi)
             + f"; the first {map_solves[0] if map_solves else 0.0:.2f}",
             span_line("online: System.process on frames the mapping "
                       "thread did not touch", idle if len(idle) else [0.0],
                       smi),
             span_line("online: System.process on frames inside a "
                       "keyframe's pipeline", full if len(full) else [0.0],
                       smi),
             f"online: {len(kf_ms)} keyframes mapped, {len(loops)} loops "
             f"closed {loops}; global BA solves and commits (thread, ms; "
             f"the forced leg's too where it ran): "
             f"{[(n, round(ms, 2)) for n, ms, _ in gba_solve]}, "
             f"{[(n, round(ms, 2)) for n, ms, _ in gba_commit]} | {smi}",
             f"online: shutdown (drain + joins) {shutdown_s[0]:.3f} s; threads "
             f"joined {joined}, queues {queues}, backend errors {errors}; "
             f"keyframes stamped by a committed GBA {stamped}",
             f"online: launches after warmup {launches}; init attempts "
             f"{n_init}; stages called after warmup that warmup did not "
             f"call: {sorted(spun - warmed)}",
             f"online result: {json.dumps(rep, default=float)} | ATE rmse "
             f"{ate.rmse:.4f} mean {ate.mean:.4f} over {ate.n_pairs} frames; "
             f"offline (phase 6, {OFFLINE_FRAMES} frames) {ate_off:.4f}, "
             f"offline + loop (phase 8) "
             f"{ate_loop:.4f} | {smi}"]
    if forced is not None:
        lines.append(f"online: no loop closed, forced GBA leg: {forced}")
    log("\n".join(lines))
    return dict(rep=rep, ate=float(ate.rmse), joined=joined, queues=queues,
                errors=errors, launches=launches, n_init=n_init,
                unwarmed=sorted(spun - warmed), gba_commit=gba_commit,
                stamped=stamped, forced=forced, n_frames=len(frames))


def forced_gba(sys_, lc_mod, real_solve):
    """The transient global BA over the online map on its own thread (as
    tests/test_torch_async_gba.py drives it on the CPU): the threads
    restart, `_launch_gba` starts the GBA thread, the caller takes the map
    lock while it solves, then the commit lands and shutdown drains and
    joins.  Returns what the gates read."""
    import threading

    solving, proceed = threading.Event(), threading.Event()

    def gated(problem, k, iters=10):
        solving.set()
        if not proceed.wait(ONLINE_WAIT):
            raise TimeoutError("forced GBA: never released")
        return real_solve(problem, k, iters=iters)

    solve, lc_mod.solve_global_ba = lc_mod.solve_global_ba, gated
    try:
        sys_.start_threads()
        live = [k for k, kf in sys_.map.keyframes.items() if not kf.bad]
        loop_kf = max(live)
        sys_.looper._launch_gba(loop_kf)
        if not solving.wait(ONLINE_WAIT):
            raise AssertionError("forced GBA: the solve never started")
        lock_free = sys_.map.update_lock.acquire(timeout=ONLINE_WAIT)
        if lock_free:
            sys_.map.update_lock.release()
        thread = sys_.looper._gba_thread.name
        proceed.set()
        sys_.shutdown(timeout=ONLINE_WAIT)
    finally:
        proceed.set()
        lc_mod.solve_global_ba = solve
    stamped = sum(kf.ba_global_for == loop_kf
                  for kf in sys_.map.keyframes.values() if not kf.bad)
    return dict(loop_kf=loop_kf, thread=thread, lock_free_mid_solve=lock_free,
                participants_stamped=stamped, live=len(live),
                joined=sys_.looper._gba_thread is None
                and sys_.looper._thread is None
                and sys_.mapper._thread is None)


def online_gates(res):
    """Phase 9's gates; raises on the first that fails."""
    rep, n = res["rep"], res["n_frames"]
    if not (rep["n_lost"] == 0 and rep["n_frames"] >= ONLINE_TRACKED
            and res["ate"] < 0.2):
        raise AssertionError(f"online gates failed (0 LOST, >= "
                             f"{ONLINE_TRACKED} tracked, ATE < 0.2): {rep}")
    if not all(res["joined"].values()) or any(res["queues"].values()):
        raise AssertionError(f"online: threads {res['joined']}, queues "
                             f"{res['queues']}")
    if res["errors"]:
        raise AssertionError(f"online: backend errors {res['errors']}")
    la = res["launches"]
    wrong = {k: la[k] for k in ONLINE_KERNELS if la[k] != n}
    if wrong or la["match"] != res["n_init"] or res["n_init"] < 1:
        raise AssertionError(f"online launches {la} for {n} frames and "
                             f"{res['n_init']} init attempts")
    if res["unwarmed"]:
        raise AssertionError(f"online: stages warmup did not call: "
                             f"{res['unwarmed']}")
    f = res["forced"]
    if f is None:
        if not (any(c[0] == "global_ba" for c in res["gba_commit"])
                and res["stamped"] > 0):
            raise AssertionError("online: no GBA committed from its thread")
    elif not (f["thread"] == "global_ba" and f["lock_free_mid_solve"]
              and f["participants_stamped"] == f["live"] and f["joined"]):
        raise AssertionError(f"online: forced GBA leg failed: {f}")


# ---------------------------------------------------------------- phase 7

FLEET_SEEDS = tuple(range(4, 12))  # held-out rooms (training used 0-3)
# cut from 100, 90, 3 and 40 for the time limit when phase 9 came: a
# stream's first 13-17 frames initialize, so 80 keep the tracked-share
# gate within reach; the localization leg stays inside stream 0's map
FLEET_FRAMES = 80     # ticks; each stream runs the first frames of the
#                       SLAM_FRAMES-frame trajectory (phase 6's)
FLEET_SHORT = 72      # the last stream ends here: idle rows for 8 ticks
FLEET_PROFILE = 1     # the last ticks, profiled apart from the rest
FLEET_TRACKED = 0.75  # tracked share gate of each stream
LOC_TICKS = 10        # localization leg: stream i runs frames 20+2i ..
#                       (cut from 20 for the time limit when phase 13 came)
FLEET_KERNELS = ("pair1", "nms", "cov", "desc_sparse", "match")
FLEET_SPANS = ("fleet/features", "fleet/dust", "fleet/coarse",
               "fleet/local", "fleet/retry", "fleet/fine")


def fleet_config():
    """The fleet's operating point: the default configuration with the
    bfloat16 frontend, whose conv_packing="auto" runs the pair1 kernel."""
    from sp_orb_slam_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, dtype="bfloat16"))


def span_stats(v):
    import numpy as np

    v = np.asarray(v, float) if len(v) else np.zeros(1)
    return (f"median {np.median(v):.2f} p90 {np.percentile(v, 90):.2f} "
            f"mean {v.mean():.2f} max {v.max():.2f} ms (n={len(v)})")


def fleet_phase(state, dev, smi, frames, gt, cfg=None):
    """The fleet on the card: 8 streams, one per held-out room, through
    StreamFleet.tick with one batched bf16 extraction a tick, then the
    gates; the localization leg follows (`localization_leg`).  Returns
    the launch counts of the ticks."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = cfg or fleet_config()
    n = len(FLEET_SEEDS)
    lengths = [FLEET_FRAMES] * (n - 1) + [FLEET_SHORT]
    fleet = StreamFleet(cfg, n, params=state, device=dev)
    t0 = time.perf_counter()
    fleet.warmup()
    torch.cuda.synchronize()
    log(f"fleet: warmup {time.perf_counter() - t0:.2f} s")

    def raws(k):
        return [frames[s][k] if k < lengths[i] else None
                for i, s in enumerate(FLEET_SEEDS)]

    n_timed = FLEET_FRAMES - FLEET_PROFILE
    per_tick = []
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n_timed):
        t1 = time.perf_counter()
        fleet.tick(raws(k))
        per_tick.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed_spans = timer_ms(fleet.timer)
    per_stream = {tag: sum(s.timer.tags[tag].total for s in fleet.systems
                           if tag in s.timer.tags)
                  for tag in ("tracking/total", "mapping")}
    # device events only: the CPU operators' events would double
    # key_averages' time and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for k in range(n_timed, FLEET_FRAMES):
            fleet.tick(raws(k))
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t1) * 1e3
    launches = read_launches("fleet", FLEET_KERNELS)
    calls = [dict(run.calls) for _, run in fleet._extractors.values()]
    log(f"fleet extractor calls: {calls}")
    if not all(c.get("replay", 0) > 0 for c in calls):
        raise AssertionError(f"fleet: an extractor never replayed: {calls}")

    kern = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kern.append((event_device_us(ev) / 1e3 / FLEET_PROFILE,
                ev.count / FLEET_PROFILE, ev.key))
    kern.sort(reverse=True)
    busy = sum(k[0] for k in kern) * FLEET_PROFILE
    stream_frames = sum(min(n_timed, m) for m in lengths)
    pt = np.asarray(per_tick)
    lines = [f"fleet: {n} streams (rooms {FLEET_SEEDS[0]}-{FLEET_SEEDS[-1]})"
             f" x {FLEET_FRAMES} ticks (the last stream {FLEET_SHORT}) at "
             f"{cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype}, "
             f"conv_packing={cfg.extractor.conv_packing} | {smi}",
             f"fleet: unprofiled ticks 0-{n_timed - 1}: wall {wall:.3f} s, "
             f"ms/tick median {np.median(pt):.2f} p90 "
             f"{np.percentile(pt, 90):.2f} mean {pt.mean():.2f} max "
             f"{pt.max():.2f}, {stream_frames / wall:.3f} stream-frames/s | "
             f"{smi}"]
    for tag in FLEET_SPANS:
        lines.append(f"fleet span {tag}: "
                     f"{span_stats(timed_spans.get(tag, []))} | {smi}")
    for tag, total in per_stream.items():
        lines.append(f"fleet per-stream {tag}: {total * 1e3 / n_timed:.2f} "
                     f"ms/tick summed over the streams | {smi}")
    lines.append(f"fleet batched stream-frames: dust {fleet.n_batched_dust} "
                 f"local {fleet.n_batched_local} motion "
                 f"{fleet.n_batched_motion} retry {fleet.n_batched_retry}")
    lines.append(f"fleet profile: ticks {n_timed}-{FLEET_FRAMES - 1} | wall "
                 f"{win_ms / FLEET_PROFILE:.2f} ms/tick (profiler on) | "
                 f"device busy {busy / FLEET_PROFILE:.2f} ms/tick | idle "
                 f"share {1 - busy / win_ms:.3f} | "
                 f"{sum(k[1] for k in kern):.0f} device events/tick | {smi}")
    lines += [f"{ms:9.3f} {c:7.0f}  {k[:100]}" for ms, c, k in
              kern[:SLAM_ROWS]]
    ok = True
    for i, (s, seed) in enumerate(zip(fleet.systems, FLEET_SEEDS)):
        rep = s.report()
        ts, poses = s.trajectory()
        tg, pg = gt[seed]
        ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
        good = (rep["n_lost"] == 0 and ate.rmse < 0.2
                and rep["n_frames"] >= FLEET_TRACKED * lengths[i])
        ok &= good
        lines.append(f"fleet stream {i} (room {seed}, {lengths[i]} frames): "
                     f"tracked {rep['n_frames']} LOST {rep['n_lost']} KFs "
                     f"{rep['n_keyframes']} points {rep['n_points']} ATE "
                     f"rmse {ate.rmse:.4f} mean {ate.mean:.4f} "
                     f"{'met' if good else 'MISSED'}")
    log("\n".join(lines))
    if not ok:
        raise AssertionError("fleet gates failed (0 LOST, >= 75 % tracked, "
                             "ATE rmse < 0.2 on every stream)")
    want = {"pair1": FLEET_FRAMES, "nms": FLEET_FRAMES, "cov": FLEET_FRAMES,
            "desc_sparse": FLEET_FRAMES, "pair1t": 0}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong or launches["match"] < n:
        raise AssertionError(f"fleet launches {launches}: want {want} and "
                             f"match >= {n}")
    localization_leg(fleet, state, dev, smi, frames, cfg)
    return launches


def timer_totals(fleet):
    """Seconds by span tag: the fleet's own spans (`fleet/*`) and its
    streams' spans summed over the streams (`streams:<tag>`)."""
    tot = {t: a.total for t, a in fleet.timer.tags.items()}
    for s in fleet.systems:
        for t, a in s.timer.tags.items():
            tot[f"streams:{t}"] = tot.get(f"streams:{t}", 0.0) + a.total
    return tot


def localization_leg(fleet, state, dev, smi, frames, cfg):
    """Stream 0's map saved; a new fleet loads it in localization mode and
    runs LOC_TICKS ticks of room FLEET_SEEDS[0], stream i from frame
    20 + 2 i: every stream is LOST right after the load (armed for cold
    relocalization) and ends OK in localization mode with a pose on >= 2/3
    of its ticks and the map frozen (tests/test_map_serialize.py:82-112)."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.slam import tracking as tr
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    out_dir = os.path.join(HERE, "out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "fleet_map.npz")
    src = fleet.systems[0]
    src.save_map(path)
    n_kf, n_pt = src.map.n_keyframes(), src.map.n_points()
    n = len(FLEET_SEEDS)
    loc = StreamFleet(cfg, n, params=state, device=dev)
    loc.load_map(path)
    if any(s.tracker.state != tr.LOST for s in loc.systems):
        raise AssertionError("localization: a stream is not LOST after the "
                             "load")
    room = frames[FLEET_SEEDS[0]]
    with_pose = [0] * n
    per_tick, tick_spans = [], []
    torch.cuda.synchronize()
    for k in range(LOC_TICKS):
        before = timer_totals(loc)
        t1 = time.perf_counter()
        res = loc.tick([room[20 + 2 * i + k] for i in range(n)])
        per_tick.append((time.perf_counter() - t1) * 1e3)
        after = timer_totals(loc)
        tick_spans.append({t: (v - before.get(t, 0.0)) * 1e3
                           for t, v in after.items()})
        for i, p in enumerate(res):
            with_pose[i] += p is not None
    torch.cuda.synchronize()
    pt = np.asarray(per_tick)
    slow, mid = int(pt.argmax()), int(np.argsort(pt)[len(pt) // 2])
    for tag, k in (("slowest", slow), ("median", mid)):
        spans = ", ".join(f"{t} {v:.2f}" for t, v in
                          sorted(tick_spans[k].items()) if v > 0)
        log(f"localization: {tag} tick {k} {pt[k]:.2f} ms: {spans} ms")
    states = [s.tracker.state for s in loc.systems]
    frozen = [(s.map.n_keyframes(), s.map.n_points()) for s in loc.systems]
    log(f"localization: map of stream 0 ({n_kf} KFs, {n_pt} points), {n} "
        f"streams x {LOC_TICKS} ticks: ms/tick median {np.median(pt):.2f} "
        f"p90 {np.percentile(pt, 90):.2f} mean {pt.mean():.2f} max "
        f"{pt.max():.2f}; ticks with a pose {with_pose}; OK "
        f"{[st == tr.OK for st in states]}; KFs/points {frozen} | {smi}")
    if not all(st == tr.OK and s.tracker.only_tracking and w * 3 >= 2 *
               LOC_TICKS and fz == (n_kf, n_pt) for st, s, w, fz in
               zip(states, loc.systems, with_pose, frozen)):
        raise AssertionError("localization gates failed (OK in "
                             "localization mode, a pose on >= 2/3 of the "
                             "ticks, the map frozen)")


CHECKS = ("pair1t", "pair1", "nms", "cov", "match", "desc_sparse",
          "desc_dense")


# --------------------------------------------------------- phases 10, 10b

HEAT_FRAMES = 40      # phase 10: the first frames of phase 6's room (cut
#                       from 120 for the time limit when phase 13 came)
HEAT_TICKS = 30       # phase 10b: ticks of rooms HEAT_ROOMS (phase 7's)
HEAT_ROOMS = (4, 5)
HEAT_SPANS = ("tracking/frame", "tracking/total", "mapping")
# the TrackingKernels stages of the dust coarse tracker, which the heat
# variant replaces
DUST_STAGES = ("dust_track", "dust_track_batch", "fused_track")


def variants_config(cfg):
    """`cfg` with the heat coarse tracker and the epipolar-walk
    triangulation (coarse_method="heat", matching_method=2)."""
    return dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking,
                                          coarse_method="heat"),
        mapping=dataclasses.replace(cfg.mapping, matching_method=2))


def dust_calls(seen):
    return {k: v for k, v in seen.items() if k[0] in DUST_STAGES}


def heat_phase(state, dev, smi, frames, slam_stats):
    """The heat coarse tracker and the epipolar walk on the card:
    `System(cfg, params, device="cuda")` at Config() defaults (752x480,
    K=896, float32) with coarse_method="heat" and matching_method=2 spins
    the first HEAT_FRAMES frames of phase 6's room with no profiler and no
    synchronize of its own; gates: 0 LOST and ATE < 0.2 (the JAX
    package's own run of these frames on the CPU met both, PERF.md),
    nms / cov / desc_sparse once a frame and match at least once, the heat
    stage called and no dust stage (`spy_stages`), method-2 triangulation
    rows dispatched and map points committed from them.  Prints ms/frame,
    `System.process` and the spans beside phase 6's over the same
    frames."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = variants_config(Config())
    frames = frames[:HEAT_FRAMES]
    ds = RenderedDataset(cfg, n_frames=SLAM_FRAMES, seed=5, noise_seed=0)
    sys_ = System(cfg, params=state, device=dev)
    seen = spy_stages(sys_.kernels)
    per_frame = time_process(sys_)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.spin(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("heat + epipolar SLAM", SLAM_KERNELS)
    spans = timer_ms(sys_.timer)

    rep = sys_.report()
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    pf = np.asarray(per_frame)
    n = len(frames)
    pf6 = slam_stats["process"][:n]
    lines = [f"heat + epipolar SLAM: {n} frames of the rendered room (seed "
             f"5) at {cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype}, "
             f"coarse_method=heat, matching_method=2 | {smi}",
             f"heat + epipolar SLAM: wall {wall:.3f} s, "
             f"{wall * 1e3 / n:.2f} ms/frame (phase 6: "
             f"{slam_stats['wall_ms']:.2f} over its {OFFLINE_FRAMES - 1} "
             f"frames) | {smi}",
             span_line("heat + epipolar System.process ms/frame", pf, smi),
             span_line(f"phase 6 System.process ms/frame, frames 0-{n - 1}",
                       pf6, smi)]
    for tag in HEAT_SPANS:
        lines.append(span_line(f"heat + epipolar span {tag}",
                               spans.get(tag, [0.0]), smi))
        lines.append(span_line(f"phase 6 span {tag}, frames 0-{n - 1}",
                               slam_stats["spans"].get(tag, [0.0])[:n], smi))
    lines.append(f"heat + epipolar stages called: "
                 f"{dict(sorted(seen.items()))}")
    lines.append(f"heat + epipolar triangulation: rows by matching_method "
                 f"{dict(sys_.kernels.tri_rows)}, map points committed "
                 f"{sys_.mapper.n_tri_points}")
    lines.append(f"heat + epipolar result: {json.dumps(rep, default=float)}"
                 f" | ATE rmse {ate.rmse:.4f} mean {ate.mean:.4f} over "
                 f"{ate.n_pairs} frames | {smi}")
    log("\n".join(lines))
    if not (rep["n_lost"] == 0 and ate.rmse < 0.2):
        raise AssertionError("heat + epipolar gates failed (0 LOST, ATE "
                             "rmse < 0.2)")
    wrong = {k: launches[k] for k in LOOP_KERNELS if launches[k] != n}
    if wrong or launches["match"] < 1:
        raise AssertionError(f"heat + epipolar launches for {n} frames: "
                             f"{launches}")
    if seen[("heat_track", False)] < 1 or dust_calls(seen):
        raise AssertionError(f"heat + epipolar: the heat stage must carry "
                             f"the coarse stage: {dict(seen)}")
    if (set(sys_.kernels.tri_rows) != {2} or sys_.kernels.tri_rows[2] < 1
            or sys_.mapper.n_tri_points < 1):
        raise AssertionError(f"heat + epipolar: no method-2 triangulation "
                             f"committed ({dict(sys_.kernels.tri_rows)}, "
                             f"{sys_.mapper.n_tri_points} points)")
    return launches


def heat_fleet_phase(state, dev, smi, rooms):
    """The fleet under the heat coarse tracker on the card:
    `StreamFleet(cfg, 2, params, device="cuda")` in bfloat16 (pair1) with
    coarse_method="heat", warmed up, then HEAT_TICKS ticks of phase 7's
    rooms HEAT_ROOMS; gates: 0 LOST per stream, the heat stage run by
    every stream on its own and no dust stage (no batched dust prepass),
    pair1, nms, cov and desc_sparse once a tick, pair1t never.  Prints
    ms/tick."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = dataclasses.replace(fleet_config(), tracking=dataclasses.replace(
        fleet_config().tracking, coarse_method="heat"))
    n = len(HEAT_ROOMS)
    fleet = StreamFleet(cfg, n, params=state, device=dev)
    seen = spy_stages(fleet.kernels)
    t0 = time.perf_counter()
    fleet.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    seen.clear()
    # each stream's heat stages, counted inside its own coarse stage
    per_stream = [0] * n
    for i, s in enumerate(fleet.systems):
        def track(frame, _i=i, _fn=s.tracker._track_dust):
            before = seen[("heat_track", False)]
            try:
                return _fn(frame)
            finally:
                per_stream[_i] += seen[("heat_track", False)] - before

        s.tracker._track_dust = track
    per_tick = []
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(HEAT_TICKS):
        t1 = time.perf_counter()
        fleet.tick([rooms[r][k] for r in HEAT_ROOMS])
        per_tick.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("heat fleet", FLEET_KERNELS[:4])
    pt = np.asarray(per_tick)
    lines = [f"heat fleet: {n} streams (rooms {HEAT_ROOMS}) x {HEAT_TICKS} "
             f"ticks at {cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, {cfg.extractor.dtype}, "
             f"conv_packing={cfg.extractor.conv_packing}, "
             f"coarse_method=heat; warmup {warm_s:.2f} s | {smi}",
             f"heat fleet: wall {wall:.3f} s, ms/tick median "
             f"{np.median(pt):.2f} p90 {np.percentile(pt, 90):.2f} mean "
             f"{pt.mean():.2f} max {pt.max():.2f} | {smi}",
             f"heat fleet: stages called {dict(sorted(seen.items()))}, heat "
             f"stages by stream {per_stream}, batched dust stream-frames "
             f"{fleet.n_batched_dust}"]
    ok = True
    for i, s in enumerate(fleet.systems):
        rep = s.report()
        ok &= rep["n_lost"] == 0 and per_stream[i] > 0
        lines.append(f"heat fleet stream {i} (room {HEAT_ROOMS[i]}): tracked "
                     f"{rep['n_frames']} LOST {rep['n_lost']} KFs "
                     f"{rep['n_keyframes']} fail_dust {rep['n_fail_dust']}")
    log("\n".join(lines))
    if not ok or dust_calls(seen) or fleet.n_batched_dust:
        raise AssertionError("heat fleet gates failed (0 LOST and the heat "
                             "stage on every stream, no dust stage)")
    want = {"pair1": HEAT_TICKS, "nms": HEAT_TICKS, "cov": HEAT_TICKS,
            "desc_sparse": HEAT_TICKS, "pair1t": 0}
    wrong = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if wrong:
        raise AssertionError(f"heat fleet launches {launches}: want {want}")
    return launches


# ---------------------------------------------------------------- phase 11

# the training pools: (width, height) -> (fx, scenes, pairs a scene); the
# first is the camera weights/sp_rendered.npz was trained with (fx 260,
# centred principal point), the second the SLAM paths' own (fx None:
# Config()'s EuRoC camera)
TRAIN_SIZES = {(320, 240): (260.0, 2, 16), (752, 480): (None, 1, 8)}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LOG = 200, 8, 10
TRAIN_LR = 1e-3
# leg (c)'s gate on the loss's fall: the mean of the last TRAIN_TAIL logged
# losses at most TRAIN_FALL of the step-0 loss, the descriptor term's at
# most TRAIN_DESC_FALL of its own.  The JAX package met 0.356 and 0.207 on
# the CPU and the port's CPU path 0.35 and 0.22 (PERF.md)
TRAIN_TAIL, TRAIN_FALL, TRAIN_DESC_FALL = 6, 0.5, 0.35
TIMED_STEPS, TIMED_WARMUP, PROFILED_STEPS = 20, 3, 3
# leg (b)'s tolerances: the loss terms relative; each gradient's max |diff|
# against its max |g|, to the CPU path in float32 and in float64.  The
# CPU's own float32 gradients part from float64 by up to 9.4e-4 of max|g|
# (convDa), the card's by up to 9.5e-5 (conv1a, whose 9 weights an output
# channel each sum 4 x 76,800 pixel products; cuDNN picks FFT and Winograd
# algorithms there) (PERF.md)
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_GRAD_TOL_F64 = 1e-4, 1e-3, 2e-4
# kernel-name fragments (lower case) -> leg (d)'s groups, the first match
# taken: cuDNN's FFT convolutions (forward or backward: their transforms
# and complex products) apart from its direct ones
TRAIN_GROUPS = (
    ("optimizer (Adam, foreach)", ("multi_tensor_apply",)),
    ("cuDNN conv, FFT (fwd or bwd)", ("fft", "cf32", "complex")),
    ("cuDNN conv backward", ("dgrad", "wgrad")),
    ("cuDNN conv forward", ("fprop", "convolve", "conv2d", "cudnn",
                            "implicit")),
    ("f32 GEMM (the InfoNCE bmm, fwd and bwd)", ("gemm", "nvjet",
                                                 "cutlass")),
)


def train_group(kernel_name):
    name = kernel_name.lower()
    return next((g for g, keys in TRAIN_GROUPS
                 if any(k in name for k in keys)), OTHER)


def train_pools():
    """Leg (a): the port's build_pool at each of TRAIN_SIZES, seed 0.
    Returns {(width, height): (cfg, pool)}."""
    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.train import superpoint_train as tt

    pools = {}
    for (w, h), (fx, scenes, pairs) in TRAIN_SIZES.items():
        t0 = time.perf_counter()
        cfg = Config() if fx is None else tt.camera_config(w, h, fx)
        pool = tt.build_pool(cfg, n_scenes=scenes, pairs_per_scene=pairs,
                             seed=0, verbose=False)
        log(f"train pool {w}x{h}: {scenes} scenes x {pairs} pairs in "
            f"{time.perf_counter() - t0:.1f} s; corner cells "
            f"{(pool['lab_a'] != 64).mean():.4f}, corresponding cells "
            f"{(pool['corr'] >= 0).mean():.4f}")
        pools[(w, h)] = (cfg, pool)
    return pools


def train_step_on(state, batch, device, dtype=None):
    """One training step of `state` on `device` from numpy `batch` (in
    `dtype`, float32 by default): the loss terms, the 24 gradients and the
    updated parameters, on the CPU."""
    import torch

    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.train import superpoint_train as tt

    dtype = dtype or torch.float32
    model = SuperPoint({k: v.to(dtype, copy=True) for k, v in state.items()})
    model = model.to(device).train()
    step = tt.make_train_step(model, TRAIN_STEPS, TRAIN_LR)
    inputs = tt.to_device(batch, device)
    inputs[:2] = [x.to(dtype) for x in inputs[:2]]
    terms = [float(t) for t in step(*inputs)]
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    return terms, grads, params


def adam_first_error(p0, p1, g):
    """max |(p0 - p1) - lr g / (|g| + 1e-8)| over a tensor, in units of the
    float32 spacing at its largest |p0| (at least lr * 1e-6, the update's
    own float32 rounding): how far one step's parameters are from Adam's
    first update of that step's own gradient."""
    import numpy as np

    p0, p1, g = (np.asarray(t, np.float64) for t in (p0, p1, g))
    want = TRAIN_LR * g / (np.abs(g) + 1e-8)
    unit = max(float(np.spacing(np.float32(np.abs(p0).max()))),
               TRAIN_LR * 1e-6)
    return float(np.abs((p0 - p1) - want).max() / unit)


def step_card_vs_cpu(state, batch, dev):
    """Leg (b): one training step on the card against the port's CPU path
    on the same numpy batch, in float32 and in float64.  The loss terms
    and the 24 gradients within the STEP_* tolerances; the parameters are
    compared through Adam: its first update moves an entry by lr * g /
    (|g| + 1e-8), about lr * sign(g), so an entry whose gradient is under
    the two devices' rounding may step either way (up to 2 lr apart); each
    device's parameters must be its own gradient's update within one
    float32 spacing.  Prints and returns its lines, and raises past the
    gates."""
    import torch

    t0 = time.perf_counter()
    card = train_step_on(state, batch, dev)
    t1 = time.perf_counter()
    cpu = train_step_on(state, batch, torch.device("cpu"))
    t2 = time.perf_counter()
    f64 = train_step_on(state, batch, torch.device("cpu"), torch.float64)
    rel = [abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0])]
    lines = [f"train step card vs cpu (B={batch[0].shape[0]}, "
             f"{batch[0].shape[2]}x{batch[0].shape[1]}; card "
             f"{t1 - t0:.2f} s with set-up, cpu {t2 - t1:.2f} s): loss / "
             f"det / desc card {card[0]} cpu {cpu[0]} (float64 {f64[0]}), "
             f"relative {' / '.join(f'{r:.2e}' for r in rel)}"]
    bad = [f"loss terms {rel}"] if max(rel) > STEP_LOSS_RTOL else []
    for k in card[1]:
        g_card, g_cpu = card[1][k], cpu[1][k]
        scale = float(g_cpu.abs().max())
        gerr = float((g_card - g_cpu).abs().max()) / scale
        g64 = f64[1][k]
        gerr64 = float((g_card.double() - g64).abs().max()
                       / g64.abs().max())
        cpu64 = float((g_cpu.double() - g64).abs().max() / g64.abs().max())
        d = (card[2][k] - cpu[2][k]).abs()
        adam = max(adam_first_error(state[k], card[2][k], g_card),
                   adam_first_error(state[k], cpu[2][k], g_cpu))
        lines.append(f"  {k:<14} grad max|diff|/max|g| {gerr:.3e}, vs f64 "
                     f"{gerr64:.3e} (cpu {cpu64:.3e}); params max|diff| "
                     f"{float(d.max()):.3e}, share > 1e-5 "
                     f"{float((d > 1e-5).float().mean()):.2e}, Adam "
                     f"{adam:.2f} spacings")
        if (gerr > STEP_GRAD_TOL or gerr64 > STEP_GRAD_TOL_F64
                or adam > 1.0):
            bad.append(k)
    log("\n".join(lines))
    if bad:
        raise AssertionError(f"training step, card vs cpu: {bad}")
    return lines


def train_timings(cfg, pool, dev, smi):
    """Leg (d): TIMED_STEPS steps at B=TRAIN_BATCH after TIMED_WARMUP,
    each between CUDA events (the host's batch draw and upload included,
    as `train` runs them; that host part is also timed alone), then
    PROFILED_STEPS steps under torch.profiler for the idle share and the
    device time by kernel group.  Returns the lines to print."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sp_orb_slam_tpu_torch.models.superpoint import (SuperPoint,
                                                         init_params)
    from sp_orb_slam_tpu_torch.train import superpoint_train as tt

    w, h = cfg.camera.width, cfg.camera.height
    model = SuperPoint(init_params(torch.Generator().manual_seed(1)))
    model = model.to(dev).train()
    step = tt.make_train_step(model, TRAIN_STEPS, TRAIN_LR)
    draws = tt.batches(pool, TRAIN_BATCH, seed=1)
    for _ in range(TIMED_WARMUP):
        step(*tt.to_device(next(draws), dev))
    torch.cuda.synchronize()
    # the host's part of a step alone: the batch draw and the upload's issue
    draw = []
    for _ in range(TIMED_WARMUP):
        t0 = time.perf_counter()
        tt.to_device(next(draws), dev)
        draw.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for m in marks[1:]:
        loss = step(*tt.to_device(next(draws), dev))[0]
        m.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    ms = np.array([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.isfinite(loss):
        raise AssertionError(f"training {w}x{h}: loss {float(loss)}")
    med = float(np.median(ms))
    lines = [f"train {w}x{h} B={TRAIN_BATCH}: {med:.3f} ms/step median "
             f"(CUDA events, {TIMED_STEPS} steps: min {ms.min():.3f} max "
             f"{ms.max():.3f}; wall {wall:.3f}), "
             f"{2 * TRAIN_BATCH * 1e3 / med:.1f} images/s, peak memory "
             f"{peak:.3f} GiB ({before:.3f} of it allocated before the "
             f"steps); the host's batch draw and upload alone "
             f"{np.median(draw):.3f} ms | {smi}"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(*tt.to_device(next(draws), dev))
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    rows = [(event_device_us(ev) / 1e3 / PROFILED_STEPS, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not ev.key.startswith("ProfilerStep")
            and event_device_us(ev) > 0]
    if not rows:
        raise AssertionError("profiler: no device time recorded")
    busy = sum(r[0] for r in rows)
    groups = {}
    for t, name in rows:
        groups[train_group(name)] = groups.get(train_group(name), 0.0) + t
    lines.append(f"  profiled {PROFILED_STEPS} steps: wall {wall_p:.3f} "
                 f"ms/step, device busy {busy:.3f}, idle share "
                 f"{1 - busy / wall_p:.3f}")
    lines += [f"  {t:9.3f} ms/step  [{g}]"
              for g, t in sorted(groups.items(), key=lambda x: -x[1])]
    lines += [f"  {t:9.3f} ms/step  {short_name(name)[:90]}"
              for t, name in sorted(rows, reverse=True)[:12]]
    return lines


def train_phase(state, dev, smi, frames):
    """Phase 11: SuperPoint training through the port's train module (the
    JAX package's training reaches no Pallas kernel: cuDNN convs and
    autograd), legs (a)-(e); see the module docstring."""
    import tempfile

    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.models import weights
    from sp_orb_slam_tpu_torch.models.superpoint import LAYERS
    from sp_orb_slam_tpu_torch.train import superpoint_train as tt

    pools = train_pools()
    cfg_s, pool_s = pools[(320, 240)]
    # (b) one step, card against the port's CPU path
    step_card_vs_cpu(state, next(tt.batches(pool_s, 2, seed=0)), dev)
    # (c) from init_params(seed 0), as `train` runs
    t0 = time.perf_counter()
    trained, hist = tt.train(cfg_s, pool_s, steps=TRAIN_STEPS,
                             batch=TRAIN_BATCH, lr=TRAIN_LR, seed=0,
                             log_every=TRAIN_LOG, verbose=False, device=dev)
    secs = time.perf_counter() - t0
    hist = np.array(hist)
    tail = hist[-TRAIN_TAIL:, 1:].mean(0)
    fall, dfall = tail[0] / hist[0, 1], tail[2] / hist[0, 3]
    log(f"train from init (seed 0), {TRAIN_STEPS} steps B={TRAIN_BATCH} "
        f"320x240 in {secs:.1f} s: history (step, loss, det, desc) "
        f"{hist.round(4).tolist()}; last {TRAIN_TAIL} logs' mean loss "
        f"{tail[0]:.4f} = {fall:.3f} of step 0's (gate {TRAIN_FALL}), desc "
        f"{tail[2]:.4f} = {dfall:.3f} (gate {TRAIN_DESC_FALL}) | {smi}")
    if not (np.isfinite(hist).all() and fall <= TRAIN_FALL
            and dfall <= TRAIN_DESC_FALL):
        raise AssertionError("training from init: the loss did not fall")
    # (d) the step's time at both sizes
    for cfg, pool in pools.values():
        log("\n".join(train_timings(cfg, pool, dev, smi)))
    # (e) the checkpoint through both loaders' format and the extractor
    ds, fa, fb, images = room_pair(frames)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sp_train.npz")
        weights.save_npz(trained, path)
        loaded = weights.load_checkpoint(path)
        with np.load(path) as z:
            files = {k: z[k].shape for k in z.files}
    want = {**{f"{n}.weight": (co, ci, k, k) for n, ci, co, k in LAYERS},
            **{f"{n}.bias": (co,) for n, ci, co, k in LAYERS}}
    same = all(torch.equal(loaded[k], trained[k]) for k in trained)
    if files != want or not same:
        raise AssertionError(f"saved checkpoint: {files} vs {want}, "
                             f"reloaded equal {same}")
    bf = with_extractor(Config(), dtype="bfloat16")
    zero_launches()
    feats, m12 = extract_and_match(bf, loaded, dev, images)
    launches = read_launches("frontend bf16, the trained checkpoint",
                             FRONTEND_KERNELS)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        feats.uv, feats.score, feats.desc, feats.cov2, feats.response,
        feats.dense_dust))
    counts = feats.count.tolist()
    log(f"trained checkpoint ({len(files)} arrays, JAX's keys and shapes) "
        f"through the bf16 extractor on room 5 frames 0 and 2: keypoints "
        f"{counts}, init matches {int((m12 >= 0).sum())}, finite {finite}")
    if not finite or min(counts) < 1:
        raise AssertionError("trained checkpoint: extractor gates failed")
    return launches


# ---------------------------------------------------------------- phase 12

VIZ_FRAMES = 40       # (a): the first frames of phase 6's room
VIZ_WAIT = 60.0       # seconds any wait of leg (a) may take
VIZ_HOLD = 1.0        # seconds paused in which no frame may start
VIZ_KERNELS = ("nms", "cov", "desc_sparse")  # once a frame; match >= 1
MESH_B = 8            # (b): streams of the sharded step, one room each
MESH_STEPS = 5        # (b): timed steps a turn, two turns a variant
MESH_TICKS = 30       # (c): ticks of rooms MESH_ROOMS (phase 7's frames);
                      # the streams initialize by tick 14-17
MESH_ROOMS = (4, 5)
MESH_TRACKED = 0.3    # (c): tracked share gate of each stream
MESH_POSE_TOL = 5e-4  # (c): |dTcw| of a split tracking batch against the
                      # same rows unsplit (tests/test_torch_mesh.py's fleet
                      # tolerance)
MESH_CHECKED = ("dust", "local", "local_wide")  # (c): split stages re-run
MESH_KERNELS = ("pair1", "nms", "cov", "desc_sparse", "match")


def viz_missing():
    """The drawing modules leg (a) needs that do not import here: PIL
    (the overlay, /frame.png) and matplotlib (the map, /map.png)."""
    missing = []
    for mod in ("PIL", "matplotlib"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    return missing


def _http(url, method="GET"):
    """(status, content type, body, ms) of one request to the viewer."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=VIZ_WAIT) as r:
            out = r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers.get("Content-Type"), e.read()
    return out + ((time.perf_counter() - t0) * 1e3,)


def _wait_for(cond, what):
    end = time.monotonic() + VIZ_WAIT
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"viewer: timed out waiting for {what}")
        time.sleep(0.01)


def _colored(img):
    """Pixels whose channels part by more than 40 from their mean: the
    status colours, never the grayscale canvas."""
    import numpy as np

    return int((np.abs(img.astype(int) - img.mean(-1, keepdims=True))
                .max(-1) > 40).sum())


def viz_phase(state, dev, smi, frames, slam_stats, missing=()):
    """Phase 12 (a): phase 6's System (752x480, K=896, float32, trained
    weights) with a LiveViewer on a free port and `set_debug_dir` over the
    first VIZ_FRAMES frames of room 5.  A client thread GETs the endpoints
    during the spin, POSTs pause (no frame may start for VIZ_HOLD s), step
    (exactly one frame) and resume; every wait has a deadline.  Gates:
    /state OK, 0 LOST, NMS / cov / desc_sparse launched once a frame and
    match at least once, a frame PNG of (480, 752, 3) per frame, >= 2 map
    PNGs and > 50 status-coloured pixels on the last frame.  Prints ms per
    frame of `System.process` beside phase 6's over the same frames, the
    debug dump's ms per frame with and without a map, and the overlay's
    and the map render's host ms alone.  A drawing module in `missing`
    (viz_missing) takes out what needs it: without matplotlib the debug
    dir (which draws maps), /map.png and the map timing; without PIL also
    the overlay, /frame.png and its gates.  The gate, the publish hook,
    /state and the controls always run."""
    import io
    import tempfile
    import threading

    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.slam.system import System
    from sp_orb_slam_tpu_torch.viz.live import LiveViewer

    pil, mpl = "PIL" not in missing, "matplotlib" not in missing
    dump = pil and mpl
    cfg = Config()
    sys_ = System(cfg, params=state, device=dev)
    counts = dict(started=0, finished=0)
    per_frame, dumps = [], []
    process, write_debug = sys_.process, sys_._write_debug

    def counted(raw):
        counts["started"] += 1
        t0 = time.perf_counter()
        try:
            process(raw)
        finally:
            per_frame.append((time.perf_counter() - t0) * 1e3)
            counts["finished"] += 1

    def timed_dump(raw, frame):
        t0 = time.perf_counter()
        write_debug(raw, frame)
        dumps.append((sys_.frame_id, (time.perf_counter() - t0) * 1e3))

    sys_.process, sys_._write_debug = counted, timed_dump
    gets = ["", "state"] + ["frame.png"] * pil + ["map.png"] * mpl
    client_log, errors = {}, []

    def client(url):
        try:
            _wait_for(lambda: sys_.frame_id >= 10 or errors, "frame 10")
            for path in gets:
                client_log[path or "/"] = _http(url + path)
            client_log["pause"] = _http(url + "control?cmd=pause", "POST")
            while True:  # the spin parks at its gate between two frames
                _wait_for(lambda: counts["started"] == counts["finished"],
                          "the frame in flight")
                n = counts["started"]
                time.sleep(0.3)
                if counts["started"] == counts["finished"] == n:
                    break
            time.sleep(VIZ_HOLD)
            client_log["held"] = counts["started"] - n
            client_log["step"] = _http(url + "control?cmd=step", "POST")
            _wait_for(lambda: counts["finished"] > n, "the stepped frame")
            time.sleep(0.5)
            client_log["stepped"] = counts["started"] - n
            client_log["resume"] = _http(url + "control?cmd=resume", "POST")
        except Exception as e:  # reported by the phase's gates
            errors.append(e)
        finally:
            sys_.paused = False  # never leave the spin parked

    ok, extra = True, []
    with tempfile.TemporaryDirectory() as tmp:
        if dump:
            sys_.set_debug_dir(tmp)
        viewer = LiveViewer(sys_)
        try:
            thread = threading.Thread(target=client, args=(viewer.url,),
                                      daemon=True)
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            thread.start()
            try:
                sys_.spin(frames[:VIZ_FRAMES])
            finally:
                thread.join(timeout=VIZ_WAIT)
            wall = time.perf_counter() - t0
            launches = read_launches("viewer", VIZ_KERNELS + ("match",))
            final_state = _http(viewer.url + "state")
            final_frame = _http(viewer.url + "frame.png") if pil else None
        finally:
            viewer.close()
        if pil:
            from PIL import Image

            img = np.asarray(Image.open(io.BytesIO(final_frame[2])))
            extra.append(f"viewer: /frame.png after the spin "
                         f"{final_frame[0]}, {img.shape}, coloured pixels "
                         f"{_colored(img)}, {final_frame[3]:.1f} ms")
            ok &= (final_frame[0] == 200 and img.shape == (480, 752, 3)
                   and _colored(img) > 50)
            extra.append(_render_times(sys_, frames, tmp, mpl, smi))
        if dump:
            good, lines = _viz_artifacts(tmp, dumps, smi)
            ok &= good
            extra += lines
    rep = sys_.report()
    state_json = json.loads(final_state[2])
    left_out = (f" (without {' and '.join(missing)}: "
                f"{'no debug dir, ' if not dump else ''}"
                f"{'no /map.png' if not mpl else ''}"
                f"{', no /frame.png' if not pil else ''})"
                if missing else " + debug dir")
    lines = [f"viewer: {VIZ_FRAMES} frames of room 5 at {cfg.camera.width}x"
             f"{cfg.camera.height}, K={cfg.runtime.max_keypoints}, "
             f"{cfg.extractor.dtype}, live viewer{left_out}: wall "
             f"{wall:.3f} s (with the {VIZ_HOLD:.0f} s pause) | {smi}",
             f"viewer: System.process ms/frame {span_stats(per_frame)}; "
             f"phase 6 (no viewer) over the same frames "
             f"{span_stats(slam_stats['process'][:VIZ_FRAMES])} | {smi}",
             "viewer: client " + ", ".join(
                 f"{k} {v[0]} {v[1]} {len(v[2])} B {v[3]:.1f} ms"
                 for k, v in client_log.items() if isinstance(v, tuple)),
             f"viewer: frames started while paused {client_log.get('held')}"
             f" in {VIZ_HOLD} s, after one step {client_log.get('stepped')}"
             f"; /state after the spin {state_json.get('state')}; "
             f"{json.dumps(rep, default=float)}"] + extra
    log("\n".join(lines))
    if errors:
        raise AssertionError(f"viewer client failed: {errors[0]!r}")
    codes = [client_log[k or "/"][0] for k in gets]
    posts = [client_log[k][0] for k in ("pause", "step", "resume")]
    if not (codes == [200] * len(gets) and posts == [200] * 3
            and client_log["held"] == 0 and client_log["stepped"] == 1):
        raise AssertionError("viewer: endpoints or pause / step gates "
                             "failed")
    if not (ok and state_json.get("state") == "OK" and rep["n_lost"] == 0
            and len(per_frame) == VIZ_FRAMES):
        raise AssertionError("viewer: artifact or tracking gates failed")
    wrong = {k: launches[k] for k in VIZ_KERNELS
             if launches[k] != VIZ_FRAMES}
    if wrong or launches["match"] < 1:
        raise AssertionError(f"viewer launches {launches}: want "
                             f"{VIZ_FRAMES} of {VIZ_KERNELS}, match >= 1")
    return launches


def _render_times(sys_, frames, tmp, mpl, smi):
    """The overlay (draw_frame, then its PNG write, each timed) and, with
    matplotlib, the map render (trajectory + draw_map + PNG write) alone on
    the last frame, host ms."""
    from sp_orb_slam_tpu_torch.viz import draw_frame, save_png

    raw, frame = frames[VIZ_FRAMES - 1], sys_.tracker.last_frame
    t_draw, t_png, t_map = [], [], []
    for _ in range(10):
        t1 = time.perf_counter()
        arr = draw_frame(frame, sys_.map,
                         dust_pids=sys_.tracker.last_dust_pids,
                         image=raw.image, K_intr=sys_.kernels.K_np,
                         state="OK")
        t2 = time.perf_counter()
        save_png(os.path.join(tmp, "again.png"), arr)
        t_draw.append((t2 - t1) * 1e3)
        t_png.append((time.perf_counter() - t2) * 1e3)
    for _ in range(3 if mpl else 0):
        from sp_orb_slam_tpu_torch.viz import draw_map

        t1 = time.perf_counter()
        _, poses = sys_.trajectory()
        draw_map(sys_.map, os.path.join(tmp, "again_map.png"),
                 current_kf=sys_.tracker.ref_kf, trajectory=poses[:, :3, 3])
        t_map.append((time.perf_counter() - t1) * 1e3)
    return (f"viewer: overlay alone: draw_frame {span_stats(t_draw)}, its "
            f"PNG write {span_stats(t_png)}; map render (trajectory + "
            f"draw_map + PNG write) alone "
            f"{span_stats(t_map) if mpl else 'not measured (no matplotlib)'}"
            f" | {smi}")


def _viz_artifacts(tmp, dumps, smi):
    """(gates met, lines) of the debug dir: a frame PNG of (480, 752, 3)
    per frame, >= 2 map PNGs, > 50 coloured pixels on the last frame, and
    the dump's ms per frame with and without a map."""
    import numpy as np
    from PIL import Image

    names = sorted(os.listdir(os.path.join(tmp, "frames")))
    shapes = {np.asarray(Image.open(os.path.join(tmp, "frames", f))).shape
              for f in names}
    maps = sorted(os.listdir(os.path.join(tmp, "map")))
    colored = _colored(np.asarray(Image.open(
        os.path.join(tmp, "frames", names[-1]))))
    with_map = [ms for fid, ms in dumps if fid % 20 == 0]
    without = [ms for fid, ms in dumps if fid % 20]
    lines = [f"viewer: debug dump ms/frame, frame PNG only "
             f"{span_stats(without)}; frame + map PNG {span_stats(with_map)}"
             f" | {smi}",
             f"viewer: frame PNGs {len(names)} of shapes {sorted(shapes)}, "
             f"map PNGs {len(maps)}, coloured pixels on the last frame "
             f"{colored}"]
    ok = (len(names) == VIZ_FRAMES and shapes == {(480, 752, 3)}
          and len(maps) >= 2 and colored > 50)
    return ok, lines


def _mesh_inputs(state, dev, rooms):
    """The sharded step's inputs: frame 2 of the MESH_B rooms of phase 7
    against frame 0 (its features from the bf16 extractor), the previous
    frame's points back-projected at depth 3 under the identity pose."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.extractor import make_extractor

    cfg = fleet_config()
    seeds = FLEET_SEEDS[:MESH_B]
    img = lambda k: torch.from_numpy(np.stack(
        [rooms[s][k].image.astype(np.float32) / 255.0 for s in seeds])).to(dev)
    prev = make_extractor(cfg, state, device=dev)(img(0))
    cam = Config().camera
    K_intr = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], device=dev)
    z = 3.0
    mp_pos = torch.stack([(prev.uv[..., 0] - K_intr[2]) / K_intr[0] * z,
                          (prev.uv[..., 1] - K_intr[3]) / K_intr[1] * z,
                          torch.full_like(prev.uv[..., 0], z)], -1)
    Tcw = torch.eye(4, device=dev).expand(MESH_B, 4, 4).contiguous()
    return (img(2), prev.desc.contiguous(), prev.uv.contiguous(),
            prev.valid.contiguous(), Tcw, mp_pos.contiguous(),
            prev.valid.clone(), K_intr)


def sharded_step_phase(state, dev, smi, rooms):
    """Phase 12 (b): `build_sharded_step` at 752x480, B=MESH_B, K=896,
    bfloat16 with the trained weights, on a 1-slot mesh (`make_mesh(1)`)
    and a 2-slot mesh of this card, against the unsharded
    `multi_stream_step`: features, match indices, inlier counts and Tcw
    (1e-4) compared stream by stream; pair1, NMS, cov, desc_sparse and
    match launched once a chunk; ms per step (CUDA events, in turns)."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.parallel.mesh import (Mesh,
                                                     build_sharded_step,
                                                     make_mesh,
                                                     multi_stream_step)

    cfg = Config()
    kw = dict(num_features=cfg.tracking.num_features,
              max_keypoints=cfg.runtime.max_keypoints,
              compute_dtype=torch.bfloat16)
    inputs = _mesh_inputs(state, dev, rooms)
    model = SuperPoint({k: v.to(dev) for k, v in state.items()}).eval()
    steps = {"unsharded": lambda: multi_stream_step(model, *inputs, **kw),
             "1-slot mesh": build_sharded_step(make_mesh(1, dev.type), state,
                                              **kw),
             "2-slot mesh": build_sharded_step(Mesh([dev, dev]), state, **kw)}
    outs, launches = {}, {}
    for name, fn in steps.items():
        call = fn if name == "unsharded" else (lambda f=fn: f(*inputs))
        steps[name] = call
        zero_launches()
        outs[name] = call()
        torch.cuda.synchronize()
        launches[name] = read_launches(f"sharded step, {name}",
                                       MESH_KERNELS)
    times = {name: [] for name in steps}
    order = list(steps) + list(steps)[::-1]
    for name in order:  # in turns: each variant timed early and late
        times[name].append(cuda_ms(steps[name], iters=MESH_STEPS))
    base = outs["unsharded"]
    lines = [f"sharded step: B={MESH_B} (rooms {FLEET_SEEDS[0]}-"
             f"{FLEET_SEEDS[MESH_B - 1]}, frame 2 against frame 0) at "
             f"{cfg.camera.width}x{cfg.camera.height}, K="
             f"{cfg.runtime.max_keypoints}, bfloat16 | {smi}"]
    ok = True
    for name, out in outs.items():
        feats, m12, n, Tcw, n_inl = out
        same_feats = [bool(torch.equal(feats.uv[b], base[0].uv[b])
                           and torch.equal(feats.desc[b], base[0].desc[b]))
                      for b in range(MESH_B)]
        m_rows = (m12 != base[1]).sum(1).tolist()
        inl_same = torch.equal(n_inl, base[4])
        dT = float((Tcw - base[3]).abs().max())
        kp_diff = [int((feats.uv[b] != base[0].uv[b]).any(-1).sum())
                   for b in range(MESH_B)]
        lines.append(
            f"sharded step {name}: ms/step {np.median(times[name]):.3f} "
            f"(turns {', '.join(f'{t:.3f}' for t in times[name])}) | "
            f"streams with bit-equal features {sum(same_feats)}/{MESH_B}, "
            f"keypoints moved by stream {kp_diff}, match12 rows differing "
            f"by stream {m_rows}, inlier counts equal {inl_same}, max |dTcw| "
            f"{dT:.2e}, matches {n.tolist()}, inliers {n_inl.tolist()} | "
            f"launches {launches[name]} | {smi}")
        # a stream whose features are bit-equal must agree in full; a
        # stream whose features moved (cuDNN may pick another algorithm for
        # another batch) is stated above and held to 95 % of its keypoints
        for b in range(MESH_B):
            if same_feats[b]:
                ok &= (m_rows[b] == 0 and int(n_inl[b]) == int(base[4][b])
                       and float((Tcw[b] - base[3][b]).abs().max()) < 1e-4)
            else:
                ok &= kp_diff[b] <= 0.05 * int(base[0].count[b])
        if name == "1-slot mesh":
            ok &= all(same_feats)
        chunks = 1 if name != "2-slot mesh" else 2
        ok &= all(launches[name][k] == chunks for k in MESH_KERNELS)
    log("\n".join(lines))
    if not ok:
        raise AssertionError("sharded step gates failed")
    return launches["2-slot mesh"]


def mesh_fleet_phase(state, dev, smi, rooms, gt):
    """Phase 12 (c): `StreamFleet(cfg, 2, params, device="cuda",
    mesh=<2 slots of this card>)` in bfloat16 (pair1), warmed up, over
    MESH_TICKS ticks of rooms MESH_ROOMS, after the same fleet without a
    mesh.  Every split dust / local batch of the mesh fleet is run again
    unsplit on the same rows (outside the tick's time and launch counts),
    and its poses are held to MESH_POSE_TOL.  The mesh fleet extracts at
    B=1 a slot where the unmeshed one extracts at B=2, and cuDNN's bfloat16
    convolutions round differently at the two batches, so the two fleets'
    features and poses are compared and stated, and each fleet is held to
    phase 7's ATE gate.  Gates: 0 LOST, a MESH_TRACKED share of the ticks
    tracked and ATE rmse < 0.2 per stream in both; the extraction split
    over 2 slots; a split dust stage and a split local stage; the re-runs'
    poses; pair1 / NMS / cov / desc_sparse launched once a slot a tick
    (once a tick without the mesh), match at least once.  Prints ms per
    tick of both.  Returns the mesh fleet's launches."""
    import numpy as np
    import torch

    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.ops import _build
    from sp_orb_slam_tpu_torch.parallel.mesh import Mesh
    from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet

    cfg = fleet_config()
    n = len(MESH_ROOMS)
    lines, launches, poses, kps, ok = [], {}, {}, {}, True
    rerun = collections.defaultdict(list)  # stage -> (max |dTcw|, differing)
    for name, mesh in (("no mesh", None), ("2-slot mesh", Mesh([dev, dev]))):
        t0 = time.perf_counter()
        fleet = StreamFleet(cfg, n, params=state, device=dev, mesh=mesh)
        fleet.warmup()
        k = fleet.kernels
        # every batched stage's placement in the ticks (not the warmup's)
        placed = []
        placement, batch = k._placement, k._batch
        aside = [0.0]  # the tick's seconds spent on the unsplit re-runs

        def spied(stage, n_rows, _placed=placed, _placement=placement):
            parts = _placement(stage, n_rows)
            _placed.append((stage, len(parts)))
            return parts

        def checked(fn, layout, rows, bank=False, desc_idx=2, valid_idx=3,
                    *, stage, _k=k, _batch=batch, _placed=placed,
                    _aside=aside):
            outs = _batch(fn, layout, rows, bank, desc_idx, valid_idx,
                          stage=stage)
            where = _k.last_batch_placement[stage]
            if stage not in MESH_CHECKED or not where["split"]:
                return outs
            t1 = time.perf_counter()
            held = (len(_placed), dict(_build.LAUNCHES), _k.batch_mesh)
            _k.batch_mesh = None
            try:
                ref = _batch(fn, layout, rows, bank, desc_idx, valid_idx,
                             stage=stage)
            finally:
                _k.batch_mesh = held[2]
                _k.last_batch_placement[stage] = where
                del _placed[held[0]:]
                _build.LAUNCHES.update(held[1])
            dT, differing = 0.0, 0
            for o, r in zip(outs, ref):
                for key, v in o.items():
                    if key.startswith("Tcw"):
                        dT = max(dT, float(np.abs(v - r[key]).max()))
                    elif v.dtype.kind in "biu":
                        differing += int(np.sum(v != r[key]))
            rerun[stage].append((dT, differing))
            _aside[0] += time.perf_counter() - t1
            return outs

        k._placement = spied
        if mesh is not None:
            k._batch = checked
        fleet.last_extract_placement = None
        per_tick, poses[name], kps[name] = [], [], []
        zero_launches()
        torch.cuda.synchronize()
        for t in range(MESH_TICKS):
            aside[0] = 0.0
            t1 = time.perf_counter()
            out = fleet.tick([rooms[r][t] for r in MESH_ROOMS])
            per_tick.append((time.perf_counter() - t1 - aside[0]) * 1e3)
            poses[name].append([None if p is None else p.copy()
                                for p in out])
            f = fleet._tick_feats
            kps[name].append((f.uv.cpu().numpy(), f.valid.cpu().numpy()))
        torch.cuda.synchronize()
        launches[name] = read_launches(f"mesh fleet, {name}", MESH_KERNELS)
        by_slots = collections.Counter(placed)
        ates = []
        for s, room in zip(fleet.systems, MESH_ROOMS):
            ts, traj = s.trajectory()
            tg, pg = gt[room]
            ates.append(ate_sim3(ts, traj[:, :3, 3], tg, pg[:, :3, 3]).rmse)
        reps = fleet.report()
        lines.append(f"mesh fleet {name}: {n} streams (rooms {MESH_ROOMS}) x "
                     f"{MESH_TICKS} ticks, {cfg.extractor.dtype}: ms/tick "
                     f"{span_stats(per_tick)} | extraction "
                     f"{fleet.last_extract_placement} | batched calls by "
                     f"(stage, chunks) {dict(sorted(by_slots.items()))} | "
                     f"LOST {[r['n_lost'] for r in reps]} tracked "
                     f"{[r['n_frames'] for r in reps]} ATE rmse "
                     f"{[round(float(a), 4) for a in ates]} | leg "
                     f"{time.perf_counter() - t0:.1f} s with the warmup | "
                     f"{smi}")
        ok &= all(r["n_lost"] == 0 and a < 0.2
                  and r["n_frames"] >= MESH_TRACKED * MESH_TICKS
                  for r, a in zip(reps, ates))
        per = 2 if mesh is not None else 1
        ok &= all(launches[name][kn] == per * MESH_TICKS
                  for kn in MESH_KERNELS[:4]) and launches[name]["match"] >= 1
        if mesh is not None:
            ok &= (fleet.last_extract_placement["slots"] == 2
                   and by_slots[("dust", 2)] > 0
                   and by_slots[("local", 2)] > 0)
    # the split stages against the same rows unsplit
    for stage in MESH_CHECKED:
        got = rerun.get(stage, [])
        dT = max((d for d, _ in got), default=0.0)
        lines.append(f"mesh fleet split {stage} batches re-run unsplit: "
                     f"{len(got)}, max |dTcw| {dT:.2e} (gate "
                     f"{MESH_POSE_TOL}), integer / bool entries differing "
                     f"{sum(c for _, c in got)}")
        ok &= dT <= MESH_POSE_TOL
    ok &= bool(rerun["dust"]) and bool(rerun["local"])
    # the two fleets' features and poses, stream by stream and tick by tick
    # a keypoint of the mesh fleet moved: no unmeshed keypoint at its uv
    moved = np.zeros((MESH_TICKS, n), int)
    dT = np.zeros((MESH_TICKS, n))
    one_sided = 0
    for t in range(MESH_TICKS):
        (ua, va), (ub, vb) = kps["no mesh"][t], kps["2-slot mesh"][t]
        for i in range(n):
            at = set(map(tuple, ua[i][va[i]].tolist()))
            moved[t, i] = sum(p not in at
                              for p in map(tuple, ub[i][vb[i]].tolist()))
        for i, (a, b) in enumerate(zip(poses["no mesh"][t],
                                       poses["2-slot mesh"][t])):
            if (a is None) != (b is None):
                one_sided += 1
            elif a is not None:
                dT[t, i] = np.abs(a - b).max()
    over = np.nonzero((dT > MESH_POSE_TOL).any(1))[0]
    lines.append(f"mesh fleet against no mesh: keypoints moved a tick by "
                 f"stream max {moved.max(0).tolist()} median "
                 f"{np.median(moved, 0).tolist()} (of "
                 f"{cfg.runtime.max_keypoints}), ticks with every keypoint "
                 f"in place {int((moved.sum(1) == 0).sum())}/{MESH_TICKS}; "
                 f"max |dTcw| by stream {[f'{v:.2e}' for v in dT.max(0)]}, "
                 f"first tick above {MESH_POSE_TOL} "
                 f"{int(over[0]) if len(over) else None}; ticks with a pose "
                 f"in one fleet only {one_sided}")
    log("\n".join(lines))
    if not ok:
        raise AssertionError("mesh fleet gates failed (0 LOST, tracked "
                             "share, ATE, split extraction and stages, the "
                             "split stages against unsplit, launches)")
    return launches["2-slot mesh"]


def mesh_phase(state, dev, smi, rooms, gt):
    """Phase 12 (b) and (c); returns (b)'s and (c)'s launches."""
    return (sharded_step_phase(state, dev, smi, rooms),
            mesh_fleet_phase(state, dev, smi, rooms, gt))


# ---------------------------------------------------------------- phase 13

TOOL_KERNELS = ("nms", "cov", "desc_sparse")  # (a)-(c); match also in (a)
REPLAY_FRAMES = 80       # (d): tests/test_depth_filter.py's frames
REPLAY_SEED = 1          # (d): tests/test_depth_filter.py's seed
SWEEP_SEEDS = (1, 2, 3)  # (e)
SWEEP_FRAMES = 50        # (e): tests/test_e2e_synthetic.py's frames (cut
#                          from the sweep tool's 80 for the time limit)
SWEEP_ATE = 0.1          # (e): the rail's gate (tests/test_e2e_synthetic.py)
TOOL_THREADS = 2         # torch threads a process: six share 8 host cores
CAPTURE_CAP = 32         # calls kept a kernel and input shape


def tool_kernels():
    """(name, module, wrapper, plain version) of each kernel the tools
    launch; the plain version takes the wrapper's arguments."""
    from sp_orb_slam_tpu_torch.ops import (cuda_cov, cuda_desc, cuda_match,
                                           cuda_nms)
    from sp_orb_slam_tpu_torch.ops.covariance import keypoint_covariance
    from sp_orb_slam_tpu_torch.ops.matching import init_match
    from sp_orb_slam_tpu_torch.ops.nms import greedy_grid_nms

    return (("nms", cuda_nms, "batched_grid_nms", greedy_grid_nms),
            ("cov", cuda_cov, "batched_covariance", keypoint_covariance),
            ("desc_sparse", cuda_desc, "sample_descriptors_sparse",
             cuda_desc.sample_descriptors_sparse_plain),
            ("match", cuda_match, "match_init_batch", init_match))


def _copy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    return tuple(map(_copy, x)) if isinstance(x, tuple) else x


@contextlib.contextmanager
def captured_calls():
    """Inside the block, each tool kernel's wrapper keeps copies of the
    inputs and outputs of its first CAPTURE_CAP calls at each input shape:
    yields {(kernel, shapes, keywords): [(args, keywords, output), ...]}.
    The wrapper still launches its kernel once a call."""
    import torch

    calls = collections.defaultdict(list)
    saved = []

    def spy(name, fn):
        def call(*args, **kw):
            key = (name, tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                               else a for a in args),
                   tuple(sorted(kw.items())))
            keep = len(calls[key]) < CAPTURE_CAP
            inputs = _copy(args) if keep else None
            out = fn(*args, **kw)
            if keep:
                calls[key].append((inputs, kw, _copy(out)))
            return out
        return call

    for name, mod, attr, _ in tool_kernels():
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, spy(name, saved[-1][2]))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _disagreement(name, plain, args, kw, got):
    """(measure, within tolerance) of one captured call against the plain
    version on its inputs, with phase 2's tolerances: NMS cells differing
    (none); cov's cov2 max_abs_err (1e-5, the response equal);
    desc_sparse's max_abs_err (1e-5, finite, invalid rows exactly 0);
    match rows differing (near-ties only)."""
    import torch

    want = plain(*args, **kw)
    if name == "nms":
        n = int((got != want).sum())
        return n, n == 0
    if name == "cov":
        err = float((got[0] - want[0]).abs().max())
        return err, err <= 1e-5 and bool(torch.equal(got[2], want[2]))
    if name == "desc_sparse":
        err = float((got - want).abs().max())
        return err, (err <= 1e-5 and bool(torch.isfinite(got).all())
                     and bool((got[~args[2]] == 0).all()))
    bad, excused = match_disagreements(args, got[0], want[0],
                                       kw.get("window", 100),
                                       kw.get("ratio", 0.9))
    return len(bad), excused == len(bad)


def captures_agree(calls, what):
    """Every call kept by `captured_calls` against its kernel's plain
    version (no kernel launch): a line a kernel and input shape, and
    raises if one disagrees."""
    plain = {name: fn for name, _, _, fn in tool_kernels()}
    lines, failed = [], []
    for (name, shapes, kw), kept in calls.items():
        res = [_disagreement(name, plain[name], a, k, out)
               for a, k, out in kept]
        dims = " ".join("x".join(map(str, s)) for s in shapes
                        if isinstance(s, tuple) and len(s) > 1)
        unit = "max_abs_err" if name in ("cov", "desc_sparse") else "differ"
        lines.append(f"{what}: {name} at {dims} {dict(kw)}: {len(res)} "
                     f"calls against the plain version, worst {unit} "
                     f"{max(r[0] for r in res):.3g}")
        if not all(r[1] for r in res):
            failed.append(f"{name} at {dims}")
    if failed:
        raise AssertionError(f"{what}: kernels disagree with their plain "
                             f"versions at the tools' shapes: {failed}")
    return lines


def replay_worker(depth_filter, device):
    """Phase 13 (d)'s run of replay_degenerate in a process of its own:
    (run_one's dict, the process's launches, its seconds).  The run ends
    in host reads of the trajectory, after the card's last work."""
    import torch

    from sp_orb_slam_tpu_torch.ops import _build
    from sp_orb_slam_tpu_torch.scripts import replay_degenerate

    torch.set_num_threads(TOOL_THREADS)
    zero_launches()
    t0 = time.perf_counter()
    out = replay_degenerate.run_one(REPLAY_SEED, depth_filter, REPLAY_FRAMES,
                                    device=device)
    return out, dict(_build.LAUNCHES), time.perf_counter() - t0


def sweep_worker(seed, device):
    """Phase 13 (e): accuracy_sweep over one seed in a process of its own,
    under `captured_calls`: (the summary, its log lines and the captures'
    comparison lines, the process's launches, its seconds)."""
    import torch

    from sp_orb_slam_tpu_torch.ops import _build
    from sp_orb_slam_tpu_torch.scripts import accuracy_sweep

    torch.set_num_threads(TOOL_THREADS)
    zero_launches()
    lines = []
    t0 = time.perf_counter()
    with captured_calls() as calls:
        sw = accuracy_sweep.sweep(
            [seed], SWEEP_FRAMES, device=device,
            log=lambda line: lines.append(f"tools (e) {line}"))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    return sw, lines + captures_agree(calls, "tools (e)"), counts, sec


def tools_phase(state, dev, smi):
    """Phase 13: the port's user tools (sp_orb_slam_tpu_torch/scripts/)
    through their functions on the card.  (a) validate_weights on the
    committed checkpoint at 752x480 (gates: phase 3's, > 150 keypoints,
    > 60 init matches, > 90 % within 3 px); (b) vlad_rendered_stats
    (printed); (c) the default fit_vlad_centroids run into a temporary
    directory (gates: the file loads through the port's load_params; the
    selected revisit - distinct margin above the random codebook's, and
    its distinct median under the detector's 0.2 candidate floor, the
    random codebook's over it; the detector margins are printed, not
    gated: at this size both packages' fits tie the random codebook's on
    the CPU, 0.093 and 0.092 against 0.092, within the k-means' own
    float32 spread), the committed weights/vlad_rendered.npz scored on the
    same held-out frames beside it; (d) replay_degenerate, seed 1, depth
    filter off and on, 80 frames (tests/test_depth_filter.py's gates: no
    more LOST frames with the filter, rmse under max(0.6, 0.8 x off)); (e)
    accuracy_sweep over seeds 1-3 x 50 frames, a seed a process, each
    warmed up (gates: 0 LOST, no failed seed, each ATE < 0.1).  (a)-(c)
    run here with the launch counters zeroed before each leg and read
    after; (d)'s two runs and (e)'s three run in five processes of their
    own beside them, each counting its own launches.  NMS / cov / desc_sparse must launch in (a)-(c), match in
    (a), (d) and (e).  In (a)-(c) and (e) each kernel's output at every
    input shape the tools give it (NMS's cluster and grid at 376x240, the
    match at the rail's K=256, ...) is held against its plain version on
    the same inputs (`captured_calls`, `captures_agree`).
    Returns the phase's launches, summed over the legs."""
    import torch

    launches = collections.Counter()
    secs = {}

    def leg(name, expected, fn):
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches.update(read_launches(f"tools ({name})", expected))
        return out

    threads = torch.get_num_threads()
    torch.set_num_threads(TOOL_THREADS)
    ctx = multiprocessing.get_context("spawn")
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=5, mp_context=ctx) as pool:
            replays = {df: pool.submit(replay_worker, df, str(dev))
                       for df in (False, True)}
            sweeps = {seed: pool.submit(sweep_worker, seed, str(dev))
                      for seed in SWEEP_SEEDS}
            with captured_calls() as calls:
                image_legs(state, dev, smi, leg)
            log("\n".join(captures_agree(calls, "tools (a)-(c)")))
            runs = {df: f.result() for df, f in replays.items()}
            seeds = {seed: f.result() for seed, f in sweeps.items()}
    finally:
        torch.set_num_threads(threads)
    for df, (_, counts, sec) in runs.items():
        name = f"d replay df={'on' if df else 'off'}"
        secs[name] = sec
        log(f"tools ({name}) launches in its process: {counts}")
        if counts["match"] < 1:
            raise AssertionError(f"tools ({name}): match never launched")
        launches.update(counts)
    off, on = runs[False][0], runs[True][0]
    log(f"tools (d) replay_degenerate seed {REPLAY_SEED}, {REPLAY_FRAMES} "
        f"frames: off {json.dumps(off)}; on {json.dumps(on)} | {smi}")
    if not (on["n_lost"] <= off["n_lost"]
            and on["rmse"] < max(0.6, 0.8 * off["rmse"])):
        raise AssertionError("tools (d): replay_degenerate gates failed")

    rows = []
    for seed, (sw, lines, counts, sec) in seeds.items():
        secs[f"e sweep seed {seed}"] = sec
        log("\n".join(lines))
        log(f"tools (e sweep seed {seed}) launches in its process: {counts}")
        if counts["match"] < 1:
            raise AssertionError(f"tools (e sweep seed {seed}): match never "
                                 f"launched")
        launches.update(counts)
        log(f"tools (e) accuracy_sweep seed {seed}, {SWEEP_FRAMES} frames: "
            f"{json.dumps(sw)} | {smi}")
        rows += sw["rows"]
    if not all(r["n_lost"] == 0 and r["ok"] and r["ate_rmse"] < SWEEP_ATE
               for r in rows):
        raise AssertionError("tools (e): accuracy_sweep gates failed")
    log("tools seconds by leg ((d) and (e) in processes of their own beside "
        "(a)-(c)): " + ", ".join(f"{k} {v:.1f}"
                                 for k, v in sorted(secs.items())))
    return launches


def image_legs(state, dev, smi, leg):
    """Phase 13's legs (a), (b) and (c), in this process."""
    import tempfile

    import numpy as np

    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.models import netvlad
    from sp_orb_slam_tpu_torch.scripts import fit_vlad_centroids as fitv
    from sp_orb_slam_tpu_torch.scripts import (validate_weights,
                                               vlad_rendered_stats)

    val = leg("a validate", TOOL_KERNELS + ("match",),
              lambda: validate_weights.validate(state, device=dev))
    log(f"tools (a) validate_weights: {json.dumps(val)} | {smi}")
    if not (min(val["n_kp"]) > 150 and val["init_matches"] > 60
            and val["init_precision"] > 0.9):
        raise AssertionError("tools (a): validate_weights gates failed")

    st = leg("b stats", TOOL_KERNELS,
             lambda: vlad_rendered_stats.stats(state, device=dev))
    log(f"tools (b) vlad_rendered_stats: {json.dumps(st)} | {smi}")

    res = leg("c fit", TOOL_KERNELS, lambda: fitv.fit(state, device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vlad_rendered.npz")
        np.savez(path, **res.save)
        loaded = netvlad.load_params(path)
    committed = fitv.codebook_score(
        netvlad.load_params(os.path.join(HERE, "weights",
                                         "vlad_rendered.npz")),
        *res.ev, res.pairs)
    fit = res.summary
    sel = fit["selected"]
    key = f"a{sel['alpha']:g}_r{sel['residual']:g}_{sel['mode']}"
    log("\n".join([
        f"tools (c) fit_vlad_centroids: {fit['n_train_desc']} training "
        f"descriptors, {fit['clusters']} clusters, selected {sel} "
        f"| {smi}",
        f"tools (c) selected {json.dumps(fit['stats'][key])}",
        f"tools (c) random codebook {json.dumps(fit['stats']['random_init'])}",
        f"tools (c) committed weights/vlad_rendered.npz on the same frames "
        f"{json.dumps(committed)}",
        f"tools (c) the written file loads: centroids "
        f"{loaded['centroids'].shape}, proj {loaded['proj'].shape}"]))
    got, rand = fit["stats"][key], fit["stats"]["random_init"]
    floor = Config().loop.min_score_floor
    if not (loaded["centroids"].shape == (fit["clusters"], 256)
            and got["margin"] > rand["margin"]
            and got["distinct"] < floor < rand["distinct"]):
        raise AssertionError("tools (c): fit_vlad_centroids gates failed")


def main(argv) -> int:
    t_start = time.perf_counter()
    kernels_only = argv[:1] == ["--kernels"]
    names = (argv[1:] or list(CHECKS)) if kernels_only else list(CHECKS)
    if (argv and not kernels_only) or not set(names) <= set(CHECKS):
        print(f"usage: chip_smoke.py [--kernels [{' '.join(CHECKS)}]]",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "sp_orb_slam_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from sp_orb_slam_tpu_torch.config import Config
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint
    from sp_orb_slam_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(force=True)
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for kname, text in sorted(logs.items()):
        for line in text.splitlines():
            # each entry's "Compiling", its stack frame and spill bytes
            # (a line of its own), its registers and shared memory
            if ("spill" in line or "ptxas info" in line
                    and ("Used" in line or "Compiling" in line)):
                log(f"  {kname}: {line.strip()}")

    if not kernels_only:
        # data is set-up: render phase 6's room and phase 7's rooms up front
        t0 = time.perf_counter()
        # phase 6's room 5 is one of phase 7's: render its longer run once
        rooms = render_all({**{s: (SLAM_FRAMES, FLEET_FRAMES)
                               for s in FLEET_SEEDS},
                            5: (SLAM_FRAMES, SLAM_FRAMES)})
        gt = {s: RenderedDataset(Config(), n_frames=SLAM_FRAMES, seed=s,
                                 noise_seed=0).gt_trajectory()
              for s in FLEET_SEEDS}
        log(f"rendered {sum(map(len, rooms.values()))} frames in "
            f"{time.perf_counter() - t0:.1f} s")
    elif {"nms", "cov"} & set(names):  # the SLAM room, for check_real
        rooms = render_all({5: (SLAM_FRAMES, SLAM_FRAMES)})

    state = load_checkpoint(os.path.join(HERE, "weights", "sp_rendered.npz"))
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = dict(pair1t=lambda: check_pair1t(state, gen, dev, logs),
                  pair1=lambda: check_pair1(state, gen, dev),
                  nms=lambda: check_nms(gen, dev),
                  cov=lambda: check_cov(gen, dev),
                  match=lambda: check_match(gen, dev),
                  desc_sparse=lambda: check_desc_sparse(gen, dev, logs),
                  desc_dense=lambda: check_desc_dense(gen, dev))
    rows = [checks[k]() for k in CHECKS if k in names]
    if {"nms", "cov"} & set(names):
        check_real(state, dev, rooms[5], names)
    log("\n".join(kernel_table(rows, launch_floor(dev), smi)))
    check_bounds(rows)
    if kernels_only:
        log(json.dumps({"kernels": [{k: r[k] for k in ROW_KEYS}
                                    for r in rows]}))
        log(f"chip_smoke --kernels: {time.perf_counter() - t_start:.1f} s "
            f"in all | {smi}")
        return 0
    def stamp(phase):  # elapsed time against the run's time limit
        log(f"chip_smoke: {phase} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    stamp("kernels")
    front, pair1t_route, dense_route = main_path(state, dev)
    s2d_pairs(state, dev, smi, rooms[5])
    step = make_step(state, dev)
    stats, carry = step_fps(step)
    log(f"step: {json.dumps(stats)} | {smi}")
    log("\n".join(profile_step(step, carry)))
    stamp("frontend and step")
    slam, ate_off, slam_stats = slam_phase(state, dev, smi, rooms[5])
    stamp("SLAM")
    fleet = fleet_phase(state, dev, smi, rooms, gt)
    stamp("fleet")
    _, ate_loop = loop_phase(state, dev, smi, rooms[5], ate_off)
    stamp("SLAM + loop")
    online = online_phase(state, dev, smi, rooms[5], ate_off, ate_loop)
    online_gates(online)
    stamp("online SLAM + loop")
    heat = heat_phase(state, dev, smi, rooms[5], slam_stats)
    stamp("heat + epipolar SLAM")
    heat_fleet = heat_fleet_phase(state, dev, smi, rooms)
    stamp("heat fleet")
    train_phase(state, dev, smi, rooms[5])
    stamp("training")
    missing = viz_missing()
    if missing:  # no drawer of our own: the CPU tests draw what is left out
        log(f"phase 12 (a): {' and '.join(missing)} not installed: what "
            f"draws with {'them' if len(missing) > 1 else 'it'} is left "
            f"out; the gate, the publish hook, /state and the controls run")
    viz = viz_phase(state, dev, smi, rooms[5], slam_stats, missing=missing)
    stamp("viewer")
    step_mesh, fleet_mesh = mesh_phase(state, dev, smi, rooms, gt)
    stamp("mesh")
    tools = tools_phase(state, dev, smi)
    stamp("tools")
    # each kernel's launches on the path that runs it: the SLAM path for
    # its kernels, the bf16 frontend with conv_packing="pair1t" for pair1t,
    # desc_method="pallas" for desc_dense, the bf16 fleet for pair1
    for r in rows:
        if r["name"] == "pair1":
            r["path"], r["launches"] = "fleet_bf16", fleet["pair1"]
        elif r["name"] in SLAM_KERNELS:
            r["path"], r["launches"] = "slam", slam[r["name"]]
        elif r["name"] == "desc_dense":
            r["path"], r["launches"] = "frontend_pallas", dense_route[
                "desc_dense"]
        else:
            r["path"], r["launches"] = ("frontend_bf16_pair1t",
                                        pair1t_route["pair1t"])
        # the launches of phase 10 (phase 10b for pair1), of phase 12's
        # viewer leg and of its mesh fleet
        r["launches_heat"] = (heat_fleet if r["name"] == "pair1"
                              else heat)[r["name"]]
        r["launches_viz"] = viz[r["name"]]
        r["launches_mesh"] = fleet_mesh[r["name"]]
        r["launches_tools"] = tools[r["name"]]
        # its device ms a launch in phase 6's profiled frame, or None
        r["path_device_ms"] = slam_stats["in_path"].get(r["name"])
    log(f"sharded step launches on the 2-slot mesh: {step_mesh}")
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "launches_heat", "launches_viz", "launches_mesh",
            "launches_tools", "path_device_ms") + ROW_KEYS[1:]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
