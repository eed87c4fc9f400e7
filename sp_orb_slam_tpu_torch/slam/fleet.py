"""Multi-stream serving: N SLAM systems, ONE batched frontend.

The port of the JAX package's slam/fleet.py.  The reference is one camera,
one System, one GPU; its only batching axis is time.  A deployment serving
N cameras on one card runs N independent tracking pipelines against one
batched extraction instead of N copies of a batch-1 frontend:

- one extraction per tick covers every live stream (B = n_streams; idle
  streams are padded by repeating row 0, so the batch is the same every
  tick), and ONE packed device-to-host copy fetches all N feature sets;
- the per-stream Systems share one TrackingKernels;
- each tick runs the phased drive: the dust stage of every OK stream as one
  batched call, the motion fallback of every stream whose dust stage failed
  as one, the local-map stage as one per window width, and the fine retry
  rounds as one wide-window call and one multi-start call a round; the
  batched calls are the stage bodies under torch.func.vmap with one packed
  upload and one packed readback (slam/kernels.py);
- in bank mode the batched stages gather each stream's point descriptors
  from its pool's device bank inside the batch (kernels.BankRows).

Host-side tracking state machines run per stream in turn.  Offline, each
mapper spins after its stream's frame; in the online mode (`cfg.online`)
each stream's mapping (and loop closing) runs on its own threads, started
by the stream's first tick and joined by `shutdown`, and the prepasses
hold each stream's map lock while they read its map.  `load_map` is the
build-once, localize-many server.

With a stream mesh (`mesh=`, parallel/mesh.py) the tick's padded image
batch is cut into one contiguous chunk per mesh slot, each extracted on its
slot's device by that device's extractor, and the gathered features go on
on the fleet's device; the batched tracking stages and the mappers'
batches split over the same slots (TrackingKernels.batch_mesh), the JAX
fleet's `batch_sharding`.  The maps' descriptor banks stay on the fleet's
device and are copied to a slot's device where it differs.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.io.dataset import RawFrame
from sp_orb_slam_tpu_torch.parallel.mesh import gather
from sp_orb_slam_tpu_torch.slam import tracking as tr
from sp_orb_slam_tpu_torch.slam.frame import frame_from_features
from sp_orb_slam_tpu_torch.slam.kernels import (BankRows, PreStacked,
                                                TrackingKernels)
from sp_orb_slam_tpu_torch.slam.system import System, build_preprocess
from sp_orb_slam_tpu_torch.utils.timing import Timer

BANK_STACKS = 4  # stacked-bank compositions kept (one per stage group a tick)
DESC = 2         # the point-descriptor slot of every batched stage's rows


class StreamFleet:
    """N concurrent monocular streams through one batched frontend."""

    def __init__(self, cfg: Config, n_streams: Optional[int] = None, *,
                 params, device: str | torch.device = "cuda", mesh=None):
        """`params`: the frontend's state dict (None for injected-feature
        streams); every stage runs on `device`, the card unless the caller
        passes "cpu" (without a card this raises).  `mesh`: a stream mesh
        (parallel/mesh.Mesh) whose slot count divides the stream count; the
        extraction and the batched stages split over its slots."""
        dev = torch.device(device)
        self.cfg = cfg
        self.device = dev
        self.n = n_streams if n_streams is not None else cfg.runtime.streams
        if mesh is not None and self.n % mesh.size:
            raise ValueError(f"{self.n} streams do not split over the "
                             f"mesh's {mesh.size} slots")
        self.mesh = mesh
        self.kernels = TrackingKernels(cfg, device=dev)
        self.kernels.batch_mesh = mesh
        self.systems = [System(cfg, kernels=self.kernels, device=dev)
                        for _ in range(self.n)]
        # (preprocess, extract) of each extraction device: the fleet's
        # device, or each distinct mesh slot's (none for injected features)
        self._extractors: dict = {}
        if params is not None:
            from sp_orb_slam_tpu_torch.extractor import make_extractor

            self._extractors = {
                d: (build_preprocess(cfg, d),
                    make_extractor(cfg, params, device=d))
                for d in (mesh.distinct() if mesh is not None else [dev])}
        self.last_extract_placement = None  # how the last extraction ran
        self.n_batched_dust = 0    # stream-frames served by the batched stages
        self.n_batched_local = 0
        self.n_batched_motion = 0  # dust-fail fallbacks served batched
        self.n_batched_retry = 0   # fine retry requests served batched
        # bank mode (kernels.BankRows): the preps hand back gather inputs
        # and the batched stages gather inside the batch
        for s in self.systems:
            s.tracker.fleet_bank_mode = True
        # stacked banks keyed by the rows' (bank, version) composition
        self._bank_stacks: dict = {}
        self._tick_feats = None         # this tick's batched extraction
        self._tick_slot: dict = {}      # stream index -> extraction row
        # the tick's phases: features (extraction + the packed readback),
        # dust, coarse (phase 1 + the motion batch), local, retry, and fine
        # (fine consumption + each stream's post-track and mapping spin)
        self.timer = Timer()

    # ------------------------------------------------------------------ tick

    def tick(self, raws: Sequence[Optional[RawFrame]]
             ) -> List[Optional[np.ndarray]]:
        """Advance every live stream by one frame.

        `raws[i] is None` marks stream i idle this tick (ended, or no new
        camera frame yet).  Returns each stream's tracked pose (Tcw, as
        System.run) or None for idle / uninitialized / LOST streams.  Image
        frames across streams are extracted in ONE batched call;
        injected-feature frames (the synthetic rail) skip extraction."""
        if len(raws) != self.n:
            raise ValueError(f"expected {self.n} streams, got {len(raws)}")
        self._tick_feats = None
        self._tick_slot = {}
        out: List[Optional[np.ndarray]] = [None] * self.n
        img_streams = [i for i, r in enumerate(raws)
                       if r is not None and r.injected is None]
        inj_streams = [i for i, r in enumerate(raws)
                       if r is not None and r.injected is not None]

        span = self.timer.span
        frames: dict = {}
        with span("fleet/features"):
            self._frames(raws, img_streams, inj_streams, frames)
        with span("fleet/dust"):
            self._dust_prepass(frames)
        with span("fleet/coarse"):
            self._coarse(frames)
        with span("fleet/local"):
            self._local_prepass(frames)
        with span("fleet/retry"):
            self._fine_retry_rounds(frames)
        with span("fleet/fine"):
            for i, frame in frames.items():
                sysi = self.systems[i]
                with sysi.timer.span("tracking/total"):
                    sysi.tracker.track_frame_fine(frame)
                sysi._post_track(frame, raws[i])
                out[i] = sysi._last_valid_pose()
        return out

    def _frames(self, raws, img_streams, inj_streams, frames: dict) -> None:
        """This tick's frames: one batched extraction and one packed
        readback for the image streams, the injected features as given."""
        if img_streams:
            feats = self._extract_batch([raws[i].image for i in img_streams])
            self._tick_feats = feats
            self._tick_slot = {i: b for b, i in enumerate(img_streams)}
            hosts = self.kernels.fetch_features_host_batch(
                feats, len(img_streams))
            for b, i in enumerate(img_streams):
                sysi = self.systems[i]
                sysi._apply_pending_toggles()
                frame = frame_from_features(feats, b, sysi.frame_id,
                                            raws[i].timestamp, hosts[b])
                frame.global_desc = raws[i].global_desc
                frames[i] = frame
        for i in inj_streams:
            sysi = self.systems[i]
            sysi._apply_pending_toggles()
            frames[i] = sysi._frame_from_injected(raws[i])
            frames[i].global_desc = raws[i].global_desc
        if self.cfg.online:  # each live stream's backend threads
            for i in frames:
                self.systems[i].start_threads()

    def _coarse(self, frames: dict) -> None:
        """Phase 1 of every stream, then the motion fallback of the streams
        whose dust stage failed as one batched call."""
        deferred = []
        for i, frame in frames.items():
            sysi = self.systems[i]
            with sysi.timer.span("tracking/total"):
                margs = sysi.tracker.coarse_phase1(frame)
            if margs is not None:
                deferred.append((i, frame, margs))
        if deferred:
            self.n_batched_motion += len(deferred)
            ids = [d[0] for d in deferred]
            rows = self._prestack([d[2] for d in deferred], ids,
                                  ((4, "desc"),))
            outs = self._run_batched(self.kernels.motion_track_batch, rows,
                                     ids)
            for (i, frame, _), o in zip(deferred, outs):
                sysi = self.systems[i]
                with sysi.timer.span("tracking/total"):
                    sysi.tracker.coarse_phase2(frame, o)

    def _extract_batch(self, images: List[np.ndarray]):
        """One extraction over the tick's images, padded to the fleet width
        by repeating row 0 (the batch is the same every tick); with a mesh,
        one per slot over its contiguous chunk, gathered on the fleet's
        device (a lone chunk is returned as it is)."""
        Hc, Wc = self.cfg.camera.height, self.cfg.camera.width
        imgs = np.stack([im.astype(np.float32)[:Hc, :Wc] / 255.0
                         for im in images])
        if len(imgs) < self.n:
            imgs = np.concatenate([imgs, np.repeat(imgs[:1],
                                                   self.n - len(imgs), 0)])
        parts = (self.mesh.split(len(imgs)) if self.mesh is not None
                 else [(self.device, 0, len(imgs))])
        feats = []
        for d, lo, hi in parts:  # every chunk enqueued before the gather
            pre, extract = self._extractors[d]
            x = torch.from_numpy(imgs[lo:hi]).to(d)
            feats.append(extract(pre(x) if pre is not None else x))
        self.last_extract_placement = dict(
            n_rows=len(imgs), split=self.mesh is not None, slots=len(parts),
            devices=[str(d) for d, _, _ in parts])
        return gather(feats, self.device)

    def _fine_retry_rounds(self, frames: dict) -> None:
        """Drive every stream's fine retry machine (tracking._fine_begin /
        _fine_step) in lock-step rounds: per round, ONE batched wide-window
        call covers the "wide" / "vel" / "polish" requests and ONE batched
        multi-start call the "reloc" requests."""
        reqs = {}
        for i, frame in frames.items():
            t = self.systems[i].tracker
            r = t.fine_begin_fleet(frame)
            if r is not None:
                reqs[i] = (t, frame, r)
        while reqs:
            nxt = {}
            wide_grp = [(i, t, f, r[1]) for i, (t, f, r) in reqs.items()
                        if r[0] != "reloc"]
            reloc_grp = [(i, t, f, r[1]) for i, (t, f, r) in reqs.items()
                         if r[0] == "reloc"]
            for grp, batch_fn, desc_pos in (
                    (wide_grp, lambda rows, bank=False: self.kernels
                     .local_map_track_batch(rows, wide=True, bank=bank),
                     ((7, "desc"),)),
                    (reloc_grp, self.kernels.reloc_track_batch,
                     ((4, "desc"),))):
                if not grp:
                    continue
                self.n_batched_retry += len(grp)
                ids = [g[0] for g in grp]
                rows = self._prestack([g[3] for g in grp], ids, desc_pos)
                outs = self._run_batched(batch_fn, rows, ids)
                for (i, t, f, _), o in zip(grp, outs):
                    r2 = t.fine_step_fleet(f, o)
                    if r2 is not None:
                        nxt[i] = (t, f, r2)
            reqs = nxt

    def _dust_prepass(self, frames: dict) -> None:
        """The dust stage of every OK stream as one batched call.  Streams
        where the prep finds nothing stage a no-points marker; streams not
        in the OK dust regime (initializing, LOST, the heat coarse tracker,
        localization-vo arbitration) keep the per-stream path."""
        if self.cfg.tracking.coarse_method == "heat":
            return
        preps = []
        for i, frame in frames.items():
            t = self.systems[i].tracker
            if t.state != tr.OK or (t.only_tracking and t.vo_mode):
                continue
            # online, the stream's mapper runs beside this: the prep walks
            # its point pool and keyframes under the map lock
            with t.map.update_lock:
                # the single-stream paths scrub replaced points before the
                # dust gather reads the last frame's bindings (R1)
                t._check_replaced_in_last_frame()
                p = t.prepare_dust(frame, bank_desc=True)
            if p is None:
                t.staged_dust = (frame, None)
            else:
                preps.append((i, t, frame, p))
        if not preps:
            return
        self.n_batched_dust += len(preps)
        ids = [p[0] for p in preps]
        rows = self._prestack([p[3][2] for p in preps], ids,
                              ((4, "dense_dust"), (5, "occ_grid"),
                               (6, "desc")))
        outs = self._run_batched(self.kernels.dust_track_batch, rows, ids)
        for (i, t, frame, (pids, Tcw_pred, _)), o in zip(preps, outs):
            t.staged_dust = (frame, (pids, Tcw_pred, o))

    def _local_prepass(self, frames: dict) -> None:
        """The fine (local-map) stage's primary call of every stream whose
        coarse phase succeeded as one batched call per window width."""
        groups = {False: [], True: []}
        for i, frame in frames.items():
            t = self.systems[i].tracker
            if t._phase is None or not t._phase[0]:
                continue        # init frame, or every coarse stage failed
            with t.map.update_lock:
                prep = t.prepare_local_map(frame, bank_desc=True)
            groups[prep["wide"]].append((i, t, frame, prep))
        for wide, grp in groups.items():
            if not grp:
                continue
            self.n_batched_local += len(grp)
            ids = [g[0] for g in grp]
            rows = self._prestack([p["args"] for _, _, _, p in grp], ids,
                                  ((7, "desc"),))
            outs = self._run_batched(
                lambda rows, w=wide, bank=False: self.kernels
                .local_map_track_batch(rows, wide=w, bank=bank), rows, ids)
            for (i, t, frame, prep), o in zip(grp, outs):
                t.staged_local = (frame, prep, o)

    def _run_batched(self, batch_fn, rows: list, stream_ids: list) -> list:
        """Run a batched stage over the rows of `stream_ids` (BankRows
        descriptor slots go to the bank layout) and charge its wall time to
        those streams' `tracking/total`, an equal share each."""
        t0 = time.perf_counter()
        rows, bank = self._bankify(rows)
        outs = batch_fn(rows, bank=bank)
        share = (time.perf_counter() - t0) / len(stream_ids)
        for i in stream_ids:
            self.systems[i].timer.add("tracking/total", share)
        return outs

    def _bankify(self, rows: list):
        """BankRows rows -> the bank layout: the host row indices take the
        descriptor slot and ONE trailing PreStacked carries the stacked
        per-stream descriptor banks.  The stack is cached, keyed by the
        rows' (bank, version) composition, so stage groups of one tick with
        different rows keep their own stacks; all rows must agree on the
        mode."""
        is_bank = [isinstance(r[DESC], BankRows) for r in rows]
        if not any(is_bank):
            return rows, False
        if not all(is_bank):
            raise ValueError("_bankify: rows disagree on bank mode")
        brs = [r[DESC] for r in rows]
        key = tuple((id(b.bank), b.version) for b in brs)
        hit = self._bank_stacks.pop(key, None)
        if hit is None:
            hit = (tuple(b.bank for b in brs),   # keeps the ids alive
                   PreStacked(torch.stack([b.bank for b in brs])))
            while len(self._bank_stacks) >= BANK_STACKS:
                self._bank_stacks.pop(next(iter(self._bank_stacks)))
        self._bank_stacks[key] = hit             # most recent last
        out = []
        for r in rows:
            rr = list(r)
            rr[DESC] = r[DESC].rows
            rr.append(hit[1])
            out.append(tuple(rr))
        return out, True

    def _prestack(self, rows: list, stream_ids: list, pos_fields) -> list:
        """Replace per-stream frame arguments (each a row of this tick's
        batched extraction) with ONE gathered PreStacked per argument
        position: one gather for the whole batch instead of N slices and a
        stack."""
        feats = self._tick_feats
        if feats is None or any(i not in self._tick_slot
                                for i in stream_ids):
            return rows
        idx = torch.tensor([self._tick_slot[i] for i in stream_ids],
                           device=self.device)
        rows = [list(r) for r in rows]
        for pos, field in pos_fields:
            ps = PreStacked(getattr(feats, field).index_select(0, idx))
            for r in rows:
                r[pos] = ps
        return [tuple(r) for r in rows]

    def warmup(self) -> None:
        """Run the batched extraction + feature readback, every
        single-stream stage (TrackingKernels.warmup: the per-stream
        cascade, init, the mappers' stages and BA) and every batched stage
        (dust unless the heat tracker runs per stream, local narrow and
        wide, motion, reloc, in bank mode) once at
        fleet width on dummy inputs, so kernel builds, library loads and
        first-use allocations leave the timed ticks."""
        cfg = self.cfg
        # injected-feature fleets never extract
        if self._extractors:
            H, W = cfg.camera.height, cfg.camera.width
            feats = self._extract_batch([np.zeros((H, W), np.uint8)])
            self.kernels.fetch_features_host_batch(feats, self.n)
        cap = self.systems[0].map.pool.capacity
        self.kernels.warmup(pool_capacity=cap)
        K = cfg.runtime.max_keypoints
        P = cfg.runtime.dust_points_cap
        L = cfg.runtime.local_points_cap
        hc, wc = cfg.grid_h, cfg.grid_w
        dev = self.device
        eye = np.eye(4, dtype=np.float32)

        def val(n):
            v = np.zeros(n, bool)
            v[:4] = True
            return v

        bank = torch.zeros((cap, 256), device=dev)
        br_p = BankRows(np.zeros(P, np.int32), val(P), bank)
        br_l = BankRows(np.zeros(L, np.int32), val(L), bank)
        desc_k = torch.zeros((K, 256), device=dev)
        uv = np.zeros((K, 2), np.float32)
        cov = np.ones((K, 2), np.float32)
        dust = torch.zeros((hc, wc), device=dev)
        occ = torch.full((hc, wc), -1, dtype=torch.int32, device=dev)
        k = self.kernels
        drow = (eye, np.zeros((P, 3), np.float32), br_p, val(P), dust, occ,
                desc_k, uv, cov, val(K))
        lrow = (eye, np.zeros((L, 3), np.float32), br_l,
                np.zeros((L, 3), np.float32), val(L), np.zeros(L, bool),
                np.full(K, -1, np.int64), desc_k, uv, cov, val(K))
        mrow = (eye, np.zeros((L, 3), np.float32), br_l, val(L), desc_k, uv,
                cov, val(K))
        rrow = (np.stack([eye] * 16), np.zeros((L, 3), np.float32), br_l,
                val(L), desc_k, uv, cov, val(K))
        stages = [(k.local_map_track_batch, lrow),
                  (lambda rows, bank: k.local_map_track_batch(
                      rows, wide=True, bank=bank), lrow),
                  (k.motion_track_batch, mrow),
                  (k.reloc_track_batch, rrow)]
        if cfg.tracking.coarse_method != "heat":
            stages.insert(0, (k.dust_track_batch, drow))
        for stage, row in stages:
            rows, bank = self._bankify([row] * self.n)
            stage(rows, bank=bank)
        self._bank_stacks.clear()

    # ------------------------------------------------------------- lifecycle

    def spin(self, datasets: Sequence, max_frames: Optional[int] = None
             ) -> None:
        """Drive N datasets to exhaustion (streams may end at different
        lengths; finished streams go idle)."""
        iters = [iter(d) for d in datasets]
        done = [False] * self.n
        n_ticks = 0
        ok = False
        try:
            while not all(done):
                raws: List[Optional[RawFrame]] = []
                for i, it in enumerate(iters):
                    raw = None if done[i] else next(it, None)
                    done[i] = raw is None
                    raws.append(raw)
                if all(r is None for r in raws):
                    break
                self.tick(raws)
                n_ticks += 1
                if max_frames is not None and n_ticks >= max_frames:
                    break
            ok = True
        finally:
            if ok:
                self.shutdown()
            elif self.cfg.online:  # a tick raised: join, undrained
                for s in self.systems:
                    s._stop_threads()

    def load_map(self, path: str, localization: bool = True) -> None:
        """Multi-camera localization server: every stream loads the same
        saved map (slam/serialize.py) and, by default, freezes it
        (localization mode).  Each stream keeps its own Map instance, so
        per-stream bookkeeping (found / visible counters, relocalization
        state) stays independent."""
        for s in self.systems:
            s.load_map(path)
            if localization:
                s.activate_localization_mode()

    def shutdown(self) -> None:
        """Online: drain and join every stream's backend threads (each
        System.shutdown, which re-raises a backend failure).  Offline
        nothing runs in the background."""
        if not self.cfg.online:
            return
        failed = None
        for s in self.systems:  # every stream joined before any raise
            try:
                s.shutdown()
            except BaseException as e:
                failed = failed or e
        if failed is not None:
            raise failed

    def report(self) -> List[dict]:
        return [s.report() for s in self.systems]
