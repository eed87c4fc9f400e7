"""The tracking state machine (frontend).

Host-side rebuild of `Tracking`/`MonoTracker` (src/tracking/tracker.cpp,
tracker_dust.cpp, mono_tracker.cpp): the per-frame decision logic runs in
Python around the fused device kernels in slam/kernels.py.

State machine (tracker.h:62-68): NO_IMAGES_YET -> NOT_INITIALIZED -> OK/LOST.
Per-frame flow (tracker.cpp:182-357):
  dust coarse track -> (fail) motion model -> (fail) brute-force ref-KF ANN
  -> TrackLocalMap -> inlier gates -> motion-model update -> KF policy ->
  relative-pose trajectory bookkeeping.
Relocalization from LOST is non-functional in the reference (stubbed,
tracker.cpp:986-1138) — here it is a working multi-start reference-KF
match — and a LOST state with <= 5 KFs triggers a system reset
(tracker.cpp:329-335).

The port of the JAX package's slam/tracking.py: the single-stream
drive (`track_frame`), the fleet's phased drive (`coarse_phase1/2`, the
`prepare_*` preps in bank mode, `fine_begin_fleet` / `fine_step_fleet`,
`track_frame_fine`; slam/fleet.py) and localization mode (`only_tracking`,
`vo_mode`); each drive holds the map lock as the JAX package's does, so
the online mode's mapping and loop threads interleave only between them.
`coarse_method="heat"` runs the heat coarse tracker in the dust stage's
place (per stream in the fleet, as in the JAX package).  The two-view
init's RANSAC draws come from a torch.Generator seeded 31415926
(initializer.cpp:77), one draw per attempt (`_init_draws`).

One deliberate difference from the JAX fleet: `coarse_phase1` scrubs
replaced points from the last frame's bindings
(`_check_replaced_in_last_frame`), as both single-stream paths do; the JAX
fleet path skips it and keeps stale ids (ROADMAP queue 3, R1).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.slam.frame import FrameData
from sp_orb_slam_tpu_torch.slam.kernels import BankRows, TrackingKernels
from sp_orb_slam_tpu_torch.slam.map import Map

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


class Tracking:
    def __init__(self, cfg: Config, world: Map, kernels: TrackingKernels,
                 mapper=None):
        self.cfg = cfg
        self.map = world
        self.k = kernels
        self.mapper = mapper
        self.state = NO_IMAGES_YET
        self.last_frame: Optional[FrameData] = None
        self.velocity: Optional[np.ndarray] = None  # Tcl
        self.ref_kf: int = -1
        self.last_kf_id_frame = 0   # mnLastKeyFrameId (frame id of last KF)
        self.matches_inliers = 0
        self.n_fail_dust = 0
        self.request_reset = False
        self.vo_mode = False        # mbVO: only-tracking drifted off the map
        self.only_tracking = False  # localization mode (InformOnlyTracking,
        #                             system.cpp:213-218): map is frozen,
        #                             KF creation gated off via the stopped
        #                             mapper; inlier counting relaxes the
        #                             n_obs > 0 condition (tracker.cpp:
        #                             580-585)
        self.last_fail = ""  # diagnostic: why the latest stage rejected
        self._seen_ba_epoch = 0  # widened-window trigger (map.ba_epoch)
        self._desc_gather_cache = {}  # (bank, cap) -> (key, device desc)
        # init state
        self._init_frame: Optional[FrameData] = None
        self._prev_matched: Optional[np.ndarray] = None
        self._init_gen = torch.Generator().manual_seed(31415926)
        # local map
        self.local_kfs: List[int] = []
        self.local_pids: List[int] = []
        self.last_dust_pids: List[int] = []  # viz: coarse candidates
        # the fused OK path and the fleet's prepasses stage results for the
        # regular consumers: (frame, payload) with payload = (pids,
        # Tcw_pred, out) or None when prepare_dust found nothing
        # (_track_dust), and (frame, prep, out) (_track_local_map)
        self.staged_dust = None
        self.staged_local = None
        self._phase = None          # (ok, was_lost) between the fleet phases
        self._coarse_ctx = None     # (was_lost, pids) across the batched
        #                             motion fallback (coarse_phase1/2)
        self._fine_st = None        # fine retry machine state (fleet drive)
        self.fleet_bank_mode = False  # set by StreamFleet: preps hand back
        #                               BankRows instead of gathering
        # trajectory bookkeeping (tracker.cpp:343-356)
        self.rel_poses: List[np.ndarray] = []
        self.refs: List[int] = []
        self.times: List[float] = []
        self.lost_flags: List[bool] = []
        # stats (tracker.h:54-59)
        self.inlier_coarse: List[int] = []
        self.inlier_fine: List[int] = []
        # per-keypoint-count ratios, pushed exactly where the reference
        # pushes them (tracker_dust.cpp:208-209, tracker.cpp:596-597)
        self.inlier_coarse_ratio: List[float] = []
        self.inlier_fine_ratio: List[float] = []
        # per-stage dust failure breakdown (the reference logs each gate
        # separately, tracker_dust.cpp:97-103,174-180,218-227)
        self.fail_dust_stages = {"no_points": 0, "n_coarse": 0,
                                 "n_match": 0, "ratio": 0}

    # ------------------------------------------------------------------ API

    def track_frame(self, frame: FrameData) -> None:
        # whole-frame map-update critical section (tracker.cpp:189): in the
        # online mode it serializes against the mapping and loop threads
        with self.map.update_lock:
            if self._begin_frame(frame):
                self._track(frame)
                self._record_trajectory(frame)

    def _begin_frame(self, frame: FrameData) -> bool:
        """The head of every drive: True when the frame goes on to the
        coarse cascade, False when it was an initialization frame."""
        self.map.advance_epoch()  # flush point-pool graveyard (map.py)
        if self.state == NO_IMAGES_YET:
            self.state = NOT_INITIALIZED
        if self.state == NOT_INITIALIZED:
            self._initialization(frame)
            if self.state == OK:
                self.velocity = np.eye(4, dtype=np.float32)
            self._record_trajectory(frame)
            self._phase = None
            return False
        return True

    # The fleet's phased drive (slam/fleet.py): coarse for every stream,
    # then ONE batched fine-stage call, then per-stream fine consumption.
    # Each phase takes the map lock on its own, so an online stream's
    # mapper can run between the phases (as between whole frames).

    def track_frame_fine(self, frame: FrameData) -> None:
        """Fleet phase 3: the fine stage (consuming any staged batched
        result) + the state / motion-model / keyframe tail + trajectory
        bookkeeping."""
        with self.map.update_lock:
            if self._phase is None:
                return
            ok, was_lost = self._phase
            self._phase = None
            self._track_fine(frame, ok, was_lost)
            self._record_trajectory(frame)

    def coarse_phase1(self, frame: FrameData):
        """Fleet phase 1 with a batchable motion fallback: the coarse
        cascade of _track_coarse, except that when the dust stage fails and
        the motion model has something to track from, the motion stage's
        arguments are RETURNED for the fleet to run as one batched call
        across every such stream (coarse_phase2 consumes)."""
        with self.map.update_lock:
            return self._coarse_phase1(frame)

    def _coarse_phase1(self, frame: FrameData):
        if not self._begin_frame(frame):
            return None
        # R1: scrub replaced points as the single-stream paths do
        self._check_replaced_in_last_frame()
        ok = False
        was_lost = self.state == LOST
        if self.state == OK:
            if self.only_tracking and self.vo_mode:
                ok = self._relocalize(frame)
                if ok:
                    self.vo_mode = False
            if not ok:
                ok = self._track_dust(frame)
            if not ok:
                self.n_fail_dust += 1
                prep = self.prepare_motion(
                    frame, bank_desc=self.fleet_bank_mode)
                if prep is not None:
                    pids, args = prep
                    self._coarse_ctx = (was_lost, pids)
                    return args
                ok = self._track_reference_kf(frame)
        else:
            ok = self._relocalize(frame)
        frame.ref_kf = self.ref_kf
        self._phase = (ok, was_lost)
        return None

    def coarse_phase2(self, frame: FrameData, out) -> None:
        """Consume the batched motion-fallback result staged by
        coarse_phase1 and finish the coarse cascade (reference-KF fallback
        on failure, as _track_coarse)."""
        with self.map.update_lock:
            was_lost, pids = self._coarse_ctx
            self._coarse_ctx = None
            ok = self._consume_motion(frame, pids, out)
            if not ok:
                ok = self._track_reference_kf(frame)
            frame.ref_kf = self.ref_kf
            self._phase = (ok, was_lost)

    # --------------------------------------------------------- initialization

    def _initialization(self, frame: FrameData) -> None:
        """mono_tracker.cpp:38-115 (SP thresholds 40/40)."""
        th = 40
        if self._init_frame is None:
            if frame.count > th:
                self._init_frame = frame
                self._prev_matched = frame.uv.copy()
                self.last_frame = frame
            return
        if frame.count <= th:
            self._init_frame = None
            return
        f1 = self._init_frame
        out = self.k.init_two_view(
            f1.desc_dev, f1.uv, f1.valid, self._prev_matched,
            frame.desc_dev, frame.uv, frame.valid, self._init_draws)
        if out["n_matches"] < th:
            self._init_frame = None
            return
        # update prev_matched for the next attempt (sp_matcher.cpp:729-732)
        m12 = out["match12"]
        has = m12 >= 0
        self._prev_matched[has] = frame.uv[np.clip(m12[has], 0, None)]
        if not out["ok"]:
            self.last_frame = frame
            return

        # parallax gate (init_min_parallax_deg): hold the init frame and
        # keep accumulating baseline until the reconstruction's median
        # triangulation parallax clears the bar — a near-zero-baseline
        # init poisons every initial depth by ~1/parallax (NOTES.md)
        min_par = self.cfg.tracking.init_min_parallax_deg
        if min_par > 0:
            tri_mask = np.asarray(out["triangulated"], bool)
            if tri_mask.any():
                X = np.asarray(out["points"])[tri_mask]
                C2 = -(out["R21"].T @ out["t21"])
                r1 = X / np.maximum(
                    np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
                d2v = X - C2
                r2 = d2v / np.maximum(
                    np.linalg.norm(d2v, axis=1, keepdims=True), 1e-9)
                cosp = np.clip((r1 * r2).sum(1), -1.0, 1.0)
                med_deg = float(np.degrees(np.arccos(np.median(cosp))))
            else:
                med_deg = 0.0
            if med_deg < min_par:
                if self.cfg.verbose:
                    print(f"[init] frame {frame.frame_id}: parallax "
                          f"{med_deg:.2f}deg < {min_par}deg, waiting",
                          flush=True)
                self.last_frame = frame
                return

        # CreateInitialMap (mono_tracker.cpp:117-224)
        f1.set_pose(np.eye(4, dtype=np.float32))
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = out["R21"]
        Tcw[:3, 3] = out["t21"]
        frame.set_pose(Tcw)

        kf_ini = self.map.add_keyframe(f1)
        kf_cur = self.map.add_keyframe(frame)
        tri = out["triangulated"]
        for i in np.nonzero(tri)[0]:
            j = int(m12[i])
            mp = self.map.create_point(out["points"][i], kf_cur.kf_id)
            self.map.add_observation(mp, kf_ini.kf_id, int(i))
            self.map.add_observation(mp, kf_cur.kf_id, j)
            self.map.compute_distinctive_descriptor(mp)
            self.map.update_desc_track(mp, kf_cur.kf_id, j)
            self.map.update_normal_and_depth(mp)
            frame.mp_ids[j] = mp.pid
        self.map.update_connections(kf_ini)
        self.map.update_connections(kf_cur)

        # global BA (20 iters) + median-depth normalization
        from sp_orb_slam_tpu_torch.slam.local_mapping import run_global_ba
        run_global_ba(self.map, self.k, iters=20)

        median_depth = self._scene_median_depth(kf_ini)
        n_tracked = sum(1 for pid in kf_cur.mp_ids if pid >= 0)
        if median_depth < 0 or n_tracked < 100:
            self.request_reset = True
            self._init_frame = None
            return
        inv_md = 1.0 / median_depth
        Tc2w = kf_cur.Tcw.copy()
        Tc2w[:3, 3] *= inv_md
        kf_cur.set_pose(Tc2w)
        for pid in kf_ini.mp_ids:
            if pid >= 0:
                self.map.pool.pos[pid] *= inv_md
                mp = self.map.get_point(int(pid))
                if mp is not None:
                    self.map.update_normal_and_depth(mp)
        frame.set_pose(kf_cur.Tcw)
        frame.ref_kf = kf_cur.kf_id

        if self.mapper is not None:
            self.mapper.insert_keyframe(kf_ini.kf_id)
            self.mapper.insert_keyframe(kf_cur.kf_id)
        self.ref_kf = kf_cur.kf_id
        self.last_kf_id_frame = frame.frame_id
        self.last_frame = frame
        self.local_kfs = [kf_cur.kf_id, kf_ini.kf_id]
        self.state = OK

    def _init_draws(self, n_matches: int) -> torch.Tensor:
        """The RANSAC sample positions of one init attempt: (iters, 8)
        uniform integers in [0, n_matches) from the tracker's generator."""
        return torch.randint(0, max(n_matches, 1),
                             (self.cfg.runtime.init_ransac_iters, 8),
                             generator=self._init_gen)

    def _scene_median_depth(self, kf) -> float:
        return self.map.scene_median_depth(kf)

    # ----------------------------------------------------------------- track

    def _track(self, frame: FrameData) -> None:
        if self.state == OK:
            self._try_fused(frame)
        ok, was_lost = self._track_coarse(frame)
        self._track_fine(frame, ok, was_lost)

    def _try_fused(self, frame: FrameData) -> bool:
        """OK-path fast lane: run coarse + fine as ONE device stage
        (kernels.fused_track) and stage both halves for the regular
        consumption path (_track_dust / _track_local_map), cutting the
        per-frame device readbacks on the success path from two to one
        (the reference's whole budget is <= 50 ms/frame,
        system.cpp:141,190-192).

        The fine half needs the local-map candidate set before the coarse
        result exists, so the set is SPECULATED from the previous frame's
        final bindings — the same bindings the dust gather itself seeds
        from, so the coarse candidates are nearly always inside it; the
        stage's device-side glue then derives kp2mp0/skip exactly as
        prepare_local_map would.  When the dust gates fail the fine half is
        discarded and the fallback cascade runs unchanged (costing the same
        roundtrips it always did).

        Localization mode keeps the two-call path (its reloc-first
        arbitration reorders the stages).

        Returns True when results were staged."""
        if (not self.cfg.tracking.fused_ok_path or self.only_tracking
                or self.cfg.tracking.coarse_method != "dust"
                or self.last_frame is None):
            return False
        # _track_coarse runs this first in the two-call path; the dust
        # gather below reads last_frame.mp_ids so it must happen up front
        # here too (idempotent)
        self._check_replaced_in_last_frame()
        prep = self.prepare_dust(frame)
        if prep is None:
            self.staged_dust = (frame, None)
            return True
        pids, Tcw_pred, args = prep
        spec = self._compute_local_map(self.last_frame.mp_ids)
        if spec is None or not spec[0] or not spec[2]:
            return False  # nothing to speculate: two-call path
        local_kfs, kf_max, lpids = spec
        L = self.cfg.runtime.local_points_cap
        lpids = lpids[:L]
        pid_to_local = {pid: i for i, pid in enumerate(lpids)}
        pool = self.map.pool
        n = len(lpids)
        pos = np.zeros((L, 3), np.float32)
        normal = np.zeros((L, 3), np.float32)
        valid = np.zeros(L, bool)
        rows = np.zeros(L, np.int32)
        idx = np.asarray(lpids, np.int64)
        pos[:n] = pool.pos[idx]
        normal[:n] = pool.normal[idx]
        rows[:n] = idx
        valid[:n] = True
        key = ("desc_track", L, id(pool), pool.bank_version("desc_track"),
               tuple(lpids))
        cached = self._desc_gather_cache.get(("desc_track", L))
        if cached is not None and cached[0] == key:
            ldesc = cached[1]
        else:
            ldesc = self.k.gather_rows(pool.device_bank("desc_track"),
                                       rows, valid)
            self._desc_gather_cache[("desc_track", L)] = (key, ldesc)
        P = self.cfg.runtime.dust_points_cap
        dust2local = np.full(P, -1, np.int32)
        for di, p in enumerate(pids):
            dust2local[di] = pid_to_local.get(p, -1)
        wide = self.map.ba_epoch != self._seen_ba_epoch
        out_d, out_f = self.k.fused_track(
            args[0], args[1], args[2], args[3], args[4], args[5],
            pos, ldesc, normal, valid, dust2local,
            args[6], args[7], args[8], args[9], wide=wide)
        self.staged_dust = (frame, (pids, Tcw_pred, out_d))
        # replicate _track_dust's acceptance gates: the fine half is only
        # staged when the coarse stage will be accepted (else the cascade
        # re-tracks from a different pose and the fine result is void)
        dcfg = self.cfg.tracking.dust
        n_match = int(out_d["n_match"])
        dust_ok = (int(out_d["n_coarse"]) >= dcfg.th_ninlier
                   and n_match >= dcfg.th_nmatch
                   and int(out_d["n_opt"]) / max(n_match, 1) > dcfg.th_ratio)
        if not dust_ok:
            return True
        if wide:
            self._seen_ba_epoch = self.map.ba_epoch
        # commit the speculated local map (what _update_local_map would set)
        self.local_kfs = local_kfs
        self.ref_kf = kf_max
        frame.ref_kf = kf_max
        self.local_pids = lpids
        # replay prepare_local_map's bound-point bookkeeping from the dust
        # result (each point is claimed by at most one keypoint)
        kp2mp = out_d["kp2mp"]
        pid_arr = np.asarray(pids, np.int64)
        for li in np.unique(kp2mp[kp2mp >= 0]):
            mp = self.map.get_point(int(pid_arr[li]))
            if mp is not None and not mp.bad:
                mp.n_visible += 1
                mp.last_frame_seen = frame.frame_id
        skip = np.asarray(out_f["skip"], bool)
        kp2mp0 = np.asarray(out_f["kp2mp0"], np.int64)
        largs = (np.asarray(out_d["Tcw"], np.float32), pos, ldesc, normal,
                 valid, skip, kp2mp0, args[6], args[7], args[8], args[9])
        self.staged_local = (frame, {"pids": lpids, "n": n, "args": largs,
                                     "wide": wide}, out_f)
        return True

    def _track_coarse(self, frame: FrameData):
        self._check_replaced_in_last_frame()
        ok = False
        was_lost = self.state == LOST
        if self.state == OK:
            if self.only_tracking and self.vo_mode:
                # mbVO arbitration (tracker.cpp localization mode): few map
                # inliers means we drifted off the frozen map — attempt
                # relocalization first and re-anchor on success, else keep
                # visual odometry alive through the normal cascade
                ok = self._relocalize(frame)
                if ok:
                    self.vo_mode = False
            if not ok:
                ok = self._track_dust(frame)
            if not ok:
                self.n_fail_dust += 1
                ok = self._track_motion_model(frame)
            if not ok:
                ok = self._track_reference_kf(frame)
        else:
            ok = self._relocalize(frame)
        frame.ref_kf = self.ref_kf
        return ok, was_lost

    def _track_fine(self, frame: FrameData, ok: bool, was_lost: bool) -> None:
        coarse_ok = ok
        if ok:
            ok = self._track_local_map(frame)
        self.state = OK if ok else LOST
        if self.cfg.verbose:
            # per-frame match/inlier log (tracker.cpp:537-540,590-594)
            print(f"[track] frame {frame.frame_id}: "
                  f"coarse={'ok' if coarse_ok else 'FAIL'} "
                  f"fine_inliers={self.matches_inliers} "
                  f"kps={frame.count} state={'OK' if ok else 'LOST'}"
                  + ("" if ok else f" why[{self.last_fail}]"), flush=True)

        if ok:
            # motion model update (tracker.cpp:283-291)
            if was_lost:
                # fresh start: the pre-LOST velocity and the stale last-frame
                # pose (a failed stage's predicted/fan pose) are both poisoned
                self.velocity = None
            elif self.last_frame is not None and self.last_frame.Tcw is not None:
                last_Twc = np.eye(4, dtype=np.float32)
                last_Twc[:3, :3] = self.last_frame.Rcw.T
                last_Twc[:3, 3] = self.last_frame.Ow
                self.velocity = frame.Tcw @ last_Twc
            else:
                self.velocity = None
            # clean VO matches: drop bindings to unobserved points (:295-303)
            for i in np.nonzero(frame.mp_ids >= 0)[0]:
                mp = self.map.get_point(int(frame.mp_ids[i]))
                if mp is None or mp.bad or mp.n_obs < 1:
                    frame.mp_ids[i] = -1
                    frame.outlier[i] = False
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
            # final outlier scrub (:319-322)
            frame.mp_ids[frame.outlier] = -1
        if self.state == LOST and self.map.n_keyframes() <= 5:
            self.request_reset = True
            return
        if frame.ref_kf < 0:
            frame.ref_kf = self.ref_kf
        self.last_frame = frame

    def _check_replaced_in_last_frame(self) -> None:
        if self.last_frame is None:
            return
        for i in np.nonzero(self.last_frame.mp_ids >= 0)[0]:
            mp = self.map.points.get(int(self.last_frame.mp_ids[i]))
            if mp is not None and mp.replaced_by >= 0:
                rep = self.map.get_point(mp.pid)
                self.last_frame.mp_ids[i] = rep.pid if rep is not None else -1

    def _update_last_frame_pose(self) -> None:
        """UpdateLastFrameOverride (tracker.cpp:471-479)."""
        if not self.rel_poses:
            return
        ref = self.map.keyframes.get(self.last_frame.ref_kf)
        if ref is not None:
            self.last_frame.set_pose(self.rel_poses[-1] @ ref.Tcw)

    def _gather_dust_points(self, frame: FrameData):
        """Candidate gathering for the coarse dust tracker, selecting the
        reference's retained variants by `tracking.dust.gather`:
        - "kf_local" (production, trackFrameDustKFLocal tracker_dust.cpp:
          34-87): >= 150 candidates from last frame, then the reference
          KF, then up to 5 covisible KFs;
        - "last" (trackFrameDust): the last frame's bound points only;
        - "kf" (trackFrameDustKF, :230-404): the reference KF's points only.
        """
        P = self.cfg.runtime.dust_points_cap
        pids: List[int] = []
        seen = set()

        def add_from(id_list):
            for pid in id_list:
                pid = int(pid)
                if pid < 0 or pid in seen:
                    continue
                mp = self.map.get_point(pid)
                if mp is None or mp.bad:
                    continue
                seen.add(pid)
                mp.in_view = False
                mp.dust_match = False
                pids.append(mp.pid)
                if len(pids) >= P:
                    return

        mode = self.cfg.tracking.dust.gather
        ref = self.map.keyframes.get(self.last_frame.ref_kf)
        n_kfs = 1
        if mode == "last":
            add_from(self.last_frame.mp_ids)
        elif mode == "kf":
            if ref is not None:
                add_from(ref.mp_ids)
        else:  # "kf_local"
            add_from(self.last_frame.mp_ids)
            if len(pids) < 150 and ref is not None:
                add_from(ref.mp_ids)
            if len(pids) < 150 and ref is not None:
                for kid in ref.best_covisible(5):
                    kf = self.map.keyframes.get(kid)
                    if kf is None or kf.bad:
                        continue
                    n_kfs += 1
                    add_from(kf.mp_ids)
                    if len(pids) >= 150:
                        break
        return pids[:P], n_kfs

    def _pad_mp_arrays(self, pids: List[int], cap: int,
                       bank: str = "desc_track", bank_desc: bool = False):
        """Point arrays for a tracking kernel: positions/validity as small
        numpy uploads, descriptors as an ON-DEVICE row gather from the
        pool's device bank (they are the one multi-MB per-frame input and
        change only at mapper events — see MapPointPool.device_bank).
        Consecutive frames with the same point set and bank version reuse
        the gathered device array outright.

        With `bank_desc` (the fleet's batched stages) no gather runs here:
        the descriptor slot carries a BankRows placeholder and the batched
        stage gathers inside the batch."""
        pos = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        rows = np.zeros(cap, np.int32)
        n = min(len(pids), cap)
        if n:
            idx = np.asarray(pids[:n], np.int64)
            pos[:n] = self.map.pool.pos[idx]
            rows[:n] = idx
            valid[:n] = True
        if bank_desc:
            pool = self.map.pool
            return pos, BankRows(rows, valid, pool.device_bank(bank),
                                 pool.bank_version(bank)), valid
        key = (bank, cap, id(self.map.pool),
               self.map.pool.bank_version(bank), tuple(pids[:n]))
        cached = self._desc_gather_cache.get((bank, cap))
        if cached is not None and cached[0] == key:
            desc = cached[1]
        else:
            desc = self.k.gather_rows(
                self.map.pool.device_bank(bank), rows, valid)
            self._desc_gather_cache[(bank, cap)] = (key, desc)
        return pos, desc, valid

    def prepare_dust(self, frame: FrameData, bank_desc: bool = False):
        """Host-side input prep for the dust coarse stage, split out so the
        fleet's prepass can batch the stage across streams.  Returns (pids,
        Tcw_pred, args) with args matching kernels.dust_track, or None when
        there is nothing to track against.  Idempotent for the same frame
        (the fallback stages re-run `_update_last_frame_pose` anyway)."""
        self._update_last_frame_pose()
        Tcw_pred = (self.velocity @ self.last_frame.Tcw
                    if self.velocity is not None else self.last_frame.Tcw)
        frame.set_pose(Tcw_pred)
        frame.mp_ids[:] = -1
        frame.ref_kf = self.last_frame.ref_kf

        pids, n_kfs = self._gather_dust_points(frame)
        self.last_dust_pids = pids  # coarse-stage candidates (viz status)
        if not pids:
            return None
        P = self.cfg.runtime.dust_points_cap
        pos, desc_track, valid = self._pad_mp_arrays(pids, P,
                                                     bank_desc=bank_desc)
        args = (Tcw_pred.astype(np.float32), pos, desc_track, valid,
                frame.dust_dev, frame.occ_grid_dev, frame.desc_dev,
                frame.uv, frame.cov2_inv, frame.valid)
        return pids, Tcw_pred, args

    def _track_dust(self, frame: FrameData) -> bool:
        """trackFrameDustKFLocal (tracker_dust.cpp:22-228)."""
        staged = self.staged_dust
        self.staged_dust = None
        d = self.cfg.tracking.dust
        if staged is not None and staged[0] is frame:
            # the fused OK path or the fleet prepass ran the stage
            if staged[1] is None:
                self.fail_dust_stages["no_points"] += 1
                return False
            pids, Tcw_pred, out = staged[1]
        else:
            prep = self.prepare_dust(frame)
            if prep is None:
                self.fail_dust_stages["no_points"] += 1
                return False
            pids, Tcw_pred, args = prep
            if (self.cfg.tracking.coarse_method == "heat"
                    and frame.heat_dev is not None):
                # the heat alignment variant (trackFrameHeat,
                # tracker_dust.cpp:405-446) behind the config switch
                out = self.k.heat_track(*args[:4], frame.heat_dev,
                                        *args[5:])
            else:
                out = self.k.dust_track(*args)

        # viz/state feedback on the candidate points
        for li, pid in enumerate(pids):
            mp = self.map.points.get(pid)
            if mp is not None:
                mp.in_view = bool(out["mp_in_view"][li])
                mp.dust_match = bool(out["mp_matched"][li])

        if out["n_coarse"] < d.th_ninlier:
            self.last_fail = (f"dust: n_coarse={int(out['n_coarse'])}"
                              f"<{d.th_ninlier}")
            self.fail_dust_stages["n_coarse"] += 1
            frame.set_pose(Tcw_pred)
            return False
        if out["n_match"] < d.th_nmatch:
            self.last_fail = (f"dust: n_match={int(out['n_match'])}"
                              f"<{d.th_nmatch}")
            self.fail_dust_stages["n_match"] += 1
            frame.set_pose(Tcw_pred)
            return False
        # bind
        kp2mp = out["kp2mp"]
        bound = kp2mp >= 0
        frame.mp_ids[bound] = np.asarray(pids, np.int64)[kp2mp[bound]]
        frame.outlier[:] = False
        frame.outlier[bound & ~out["post_inlier"]] = True
        frame.set_pose(out["Tcw"])

        n_opt = int(out["n_opt"])
        self.inlier_coarse.append(n_opt)
        self.inlier_coarse_ratio.append(n_opt / max(frame.count, 1))
        if n_opt * 1.0 / max(int(out["n_match"]), 1) > d.th_ratio:
            return True
        self.last_fail = (f"dust: ratio {n_opt}/{int(out['n_match'])}"
                          f"<={d.th_ratio}")
        self.fail_dust_stages["ratio"] += 1
        frame.set_pose(Tcw_pred)
        return False

    def prepare_motion(self, frame: FrameData, bank_desc: bool = False):
        """Host-side input prep for the motion-model fallback, split out so
        the fleet can batch the stage across every stream whose dust stage
        failed this tick.  Returns (pids, args) matching
        kernels.motion_track, or None when the model has nothing to track
        from."""
        if self.velocity is None:
            return None
        self._update_last_frame_pose()
        Tcw_pred = self.velocity @ self.last_frame.Tcw
        frame.mp_ids[:] = -1
        frame.outlier[:] = False

        pids = [int(p) for i, p in enumerate(self.last_frame.mp_ids)
                if p >= 0 and not self.last_frame.outlier[i]]
        pids = [p for p in pids
                if (mp := self.map.get_point(p)) is not None and not mp.bad]
        if not pids:
            return None
        P = self.cfg.runtime.local_points_cap
        pos, desc_track, valid = self._pad_mp_arrays(pids, P,
                                                     bank_desc=bank_desc)
        args = (Tcw_pred.astype(np.float32), pos, desc_track, valid,
                frame.desc_dev, frame.uv, frame.cov2_inv, frame.valid)
        return pids, args

    def _track_motion_model(self, frame: FrameData) -> bool:
        """TrackWithMotionModel (tracker.cpp:480-559)."""
        prep = self.prepare_motion(frame)
        if prep is None:
            return False
        pids, args = prep
        out = self.k.motion_track(*args)
        return self._consume_motion(frame, pids, out)

    def _consume_motion(self, frame: FrameData, pids, out) -> bool:
        """Binding/acceptance half of the motion-model stage (the part after
        the kernel, tracker.cpp:524-559)."""
        kp2mp = out["kp2mp"]
        bound = kp2mp >= 0
        frame.mp_ids[bound] = np.asarray(pids, np.int64)[
            np.clip(kp2mp[bound], 0, len(pids) - 1)]
        frame.outlier[bound & ~out["inlier"]] = True
        frame.set_pose(out["Tcw"])
        # discard outliers + count map inliers (tracker.cpp:524-545)
        n_map = 0
        for i in np.nonzero(bound)[0]:
            pid = int(frame.mp_ids[i])
            mp = self.map.get_point(pid)
            if frame.outlier[i]:
                frame.mp_ids[i] = -1
                frame.outlier[i] = False
                if mp is not None:
                    mp.last_frame_seen = frame.frame_id
            elif mp is not None and mp.n_obs > 0:
                n_map += 1
        if self.only_tracking:
            # mbVO relaxation (tracker.cpp:553-557): against a frozen map
            # the bound-inlier count decays as the camera leaves the mapped
            # region; accept on raw match count and let TrackLocalMap's
            # widened-window search make the call.
            self.vo_mode = n_map < self.cfg.tracking.motion.th_nmatch_opt
            return int(out["n_match"]) > self.cfg.tracking.motion.th_nmatch_proj
        if n_map < self.cfg.tracking.motion.th_nmatch_opt:
            self.last_fail = (f"motion: n_map={n_map}"
                              f"<{self.cfg.tracking.motion.th_nmatch_opt} "
                              f"(n_match={int(out['n_match'])})")
            return False
        return True

    def _relocalize(self, frame: FrameData) -> bool:
        """Recovery from LOST.

        The reference's Relocalization is stubbed dead code (returns false,
        tracker.cpp:986-1138), so a LOST reference build stays lost until
        the <=5-KF reset — measured here as 30+-frame LOST streaks wedged
        on a single bad reference KF (the brute-force matcher keeps finding
        ~35 descriptor matches whose *depths* were poisoned by a turn-apex
        triangulation, so pose optimization rejects them every frame).
        This working version follows the stub's intended shape (place-
        recognition candidates -> per-candidate match + pose fit): try the
        current reference KF, then the most recent KFs, then the best
        global-descriptor candidates, and re-anchor on the first that
        yields a valid pose."""
        cands: List[int] = []
        if self.ref_kf >= 0:
            cands.append(self.ref_kf)
        alive = sorted(k for k, kf in self.map.keyframes.items()
                       if not kf.bad)
        if frame.global_desc is None and self.map.global_desc_fn is not None:
            # image datasets compute the place-recognition descriptor only
            # at keyframe promotion (Map.add_keyframe); a LOST query frame
            # needs it now, or the far-candidate channel below is dead
            frame.global_desc = self.map.global_desc_fn(frame)
        cands += [k for k in reversed(alive[-5:]) if k not in cands]
        if frame.global_desc is not None:
            scored = []
            for k in alive:
                kf = self.map.keyframes[k]
                if kf.global_desc is None or k in cands:
                    continue
                scored.append((float(frame.global_desc @ kf.global_desc), k))
            scored.sort(reverse=True)
            far = [k for _, k in scored[:3]]
        else:
            far = []
        attempts = []
        for k in cands[:8] + far:
            # multi-start fan: the camera may be anywhere between the last
            # tracked pose and the candidate's own pose, and the 4x10
            # PoseOptimization diverges-to-zero-inliers from a far start
            T0s = self._reloc_starts(self.map.keyframes[k].Tcw)
            if self._track_reference_kf(frame, ref_id=k, T0s=T0s):
                self.ref_kf = k
                return True
            attempts.append(f"kf{k}({self.last_fail})")
        self.last_fail = "reloc: " + "; ".join(attempts)
        return False

    def _reloc_starts(self, cand_Tcw: np.ndarray) -> np.ndarray:
        """(16, 4, 4) initial poses: a yaw fan (in the camera frame) around
        two bases — the last tracked pose and the candidate KF's pose."""
        bases = []
        if self.last_frame is not None and self.last_frame.Tcw is not None:
            bases.append(self.last_frame.Tcw)
        bases.append(cand_Tcw)
        while len(bases) < 2:
            bases.append(cand_Tcw)
        yaws = (0.0, 0.2, -0.2, 0.45, -0.45, 0.8, -0.8)
        pitches = (0.25, -0.25)
        starts = []
        for B in bases[:2]:
            for y in yaws:
                c, s = np.cos(y), np.sin(y)
                R = np.array([[c, 0, s, 0], [0, 1, 0, 0],
                              [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)
                starts.append(R @ B)  # left-multiply = rotate camera in place
        for p in pitches:
            c, s = np.cos(p), np.sin(p)
            R = np.array([[1, 0, 0, 0], [0, c, -s, 0],
                          [0, s, c, 0], [0, 0, 0, 1]], np.float32)
            starts.append(R @ bases[0])
        return np.stack(starts).astype(np.float32)

    def _track_reference_kf(self, frame: FrameData, ref_id: int = None,
                            T0s: np.ndarray = None) -> bool:
        """trackReferenceKeyFrameANN (tracker.cpp:372-417); with T0s given
        (relocalization) runs the multi-start variant instead."""
        ref = self.map.keyframes.get(self.ref_kf if ref_id is None
                                     else ref_id)
        if ref is None or ref.bad:
            self.last_fail = "ref: kf missing/bad"
            return False
        frame.mp_ids[:] = -1
        frame.outlier[:] = False
        # train set: the ref KF's *observed* keypoint descriptors
        kf_pids = ref.mp_ids
        rows = []
        pids = []
        for i, pid in enumerate(kf_pids):
            if pid < 0:
                continue
            mp = self.map.get_point(int(pid))
            if mp is None or mp.bad:
                continue
            rows.append(i)
            pids.append(mp.pid)
        if not pids:
            self.last_fail = "ref: no live points"
            return False
        K = self.cfg.runtime.max_keypoints
        pos = np.zeros((K, 3), np.float32)
        valid = np.zeros(K, bool)
        rows_pad = np.zeros(K, np.int32)
        n = min(len(pids), K)
        pos[:n] = self.map.pool.pos[np.asarray(pids[:n])]
        rows_pad[:n] = np.asarray(rows[:n], np.int32)
        valid[:n] = True
        # the KF's descriptors are immutable and device-resident: gather
        # the observation rows on the device
        desc = self.k.gather_rows(ref.data.desc_dev, rows_pad, valid)
        if T0s is not None:
            out = self.k.reloc_track(
                T0s, pos, desc, valid, frame.desc_dev, frame.uv,
                frame.cov2_inv, frame.valid)
        else:
            T0 = (self.last_frame.Tcw if self.last_frame is not None
                  and self.last_frame.Tcw is not None
                  else np.eye(4, np.float32))
            out = self.k.ref_track(
                T0.astype(np.float32), pos, desc, valid, frame.desc_dev,
                frame.uv, frame.cov2_inv, frame.valid)
        kp2mp = out["kp2mp"]
        bound = kp2mp >= 0
        frame.mp_ids[bound] = np.asarray(pids, np.int64)[
            np.clip(kp2mp[bound], 0, len(pids) - 1)]
        frame.outlier[bound & ~out["inlier"]] = True
        frame.set_pose(out["Tcw"])
        n_map = 0
        for i in np.nonzero(bound)[0]:
            pid = int(frame.mp_ids[i])
            mp = self.map.get_point(pid)
            if frame.outlier[i]:
                frame.mp_ids[i] = -1
                frame.outlier[i] = False
                if mp is not None:
                    mp.last_frame_seen = frame.frame_id
            elif mp is not None and mp.n_obs > 0:
                n_map += 1
        if self.only_tracking and T0s is None:
            # same mbVO relaxation as the motion model: the fine stage gates
            self.vo_mode = n_map < self.cfg.tracking.motion.th_nmatch_opt
            return int(out["n_match"]) > self.cfg.tracking.motion.th_nmatch_proj
        if n_map < self.cfg.tracking.motion.th_nmatch_opt:
            self.last_fail = (f"ref: n_map={n_map}"
                              f"<{self.cfg.tracking.motion.th_nmatch_opt} "
                              f"(n_match={int(out['n_match'])}, "
                              f"n_inlier={int(out['n_inlier'])})")
            return False
        return True

    # ---------------------------------------------------------- local map

    def _update_local_map(self, frame: FrameData) -> None:
        """UpdateLocalKeyFrames/Points (tracker.cpp:868-984, 843-866).

        Expansion semantics verified line-by-line against the reference
        (tests/test_tracking_units.py): the seed set is every observer of a
        currently-bound point; then ONE pass over a *snapshot* of that list
        (itEndKF is captured before the loop, tracker.cpp:933-935) grows it
        by, per listed KF: the first unmarked of its top-20 covisible
        (inner break, :945-955), the first unmarked child (inner break,
        :958-970), and its parent — whose branch `break`s the OUTER loop
        (:974-981), an ORB-SLAM2 quirk the reference preserves and so do
        we.  The 80-KF cap is checked at the top of each iteration."""
        res = self._compute_local_map(frame.mp_ids, scrub_frame=frame)
        if res is None:
            return
        local_kfs, kf_max, pids = res
        self.local_kfs = local_kfs
        if not local_kfs:
            return
        self.ref_kf = kf_max
        frame.ref_kf = kf_max
        self.local_pids = pids

    def _compute_local_map(self, mp_ids: np.ndarray, scrub_frame=None):
        """Pure local-map computation from a binding array (the body of
        _update_local_map, factored so the fused OK path can speculate from
        the PREVIOUS frame's final bindings without mutating tracker state).
        Returns (local_kfs, kf_max, pids) — local_kfs may be empty — or
        None when no observer counts exist.  When `scrub_frame` is given,
        bad bindings are cleared from its mp_ids in place (the reference's
        in-loop scrub, tracker.cpp:905-912)."""
        counter = {}
        for i in np.nonzero(mp_ids >= 0)[0]:
            mp = self.map.get_point(int(mp_ids[i]))
            if mp is None or mp.bad:
                if scrub_frame is not None:
                    scrub_frame.mp_ids[i] = -1
                continue
            for kid in mp.obs:
                counter[kid] = counter.get(kid, 0) + 1
        if not counter:
            return None
        local_kfs = [k for k in counter
                     if (kf := self.map.keyframes.get(k)) is not None
                     and not kf.bad]
        if not local_kfs:
            return local_kfs, -1, []
        # max-count anchor over *good* KFs only (the reference skips bad
        # KFs before the max update, tracker.cpp:920-929)
        kf_max = max(local_kfs, key=counter.get)
        marked = set(local_kfs)
        for kid in list(local_kfs):
            if len(local_kfs) > self.cfg.runtime.local_kfs_cap:
                break
            kf = self.map.keyframes[kid]
            for nb in kf.best_covisible(20):
                nkf = self.map.keyframes.get(nb)
                if nkf is not None and not nkf.bad and nb not in marked:
                    local_kfs.append(nb)
                    marked.add(nb)
                    break
            for ch in kf.children:
                ckf = self.map.keyframes.get(ch)
                if ckf is not None and not ckf.bad and ch not in marked:
                    local_kfs.append(ch)
                    marked.add(ch)
                    break
            if kf.parent >= 0 and kf.parent not in marked:
                local_kfs.append(kf.parent)
                marked.add(kf.parent)
                break
        # local points
        pids = []
        seen = set()
        for kid in local_kfs:
            kf = self.map.keyframes[kid]
            for pid in kf.mp_ids:
                if pid >= 0 and pid not in seen:
                    mp = self.map.get_point(int(pid))
                    if mp is not None and not mp.bad:
                        seen.add(int(pid))
                        pids.append(mp.pid)
        return local_kfs, kf_max, pids

    def prepare_local_map(self, frame: FrameData, bank_desc: bool = False):
        """Host-side prep for the fine stage, split out so the fleet
        prepass can batch the primary call across streams.  Returns {pids,
        n, args, wide}; mutates visibility bookkeeping, so it runs exactly
        once per frame (the staged path skips the re-prep)."""
        self._update_local_map(frame)
        L = self.cfg.runtime.local_points_cap
        pids = self.local_pids[:L]
        pid_to_local = {pid: i for i, pid in enumerate(pids)}

        # bookkeeping on currently-bound points (:771-789)
        bound_pids = set()
        for i in np.nonzero(frame.mp_ids >= 0)[0]:
            mp = self.map.get_point(int(frame.mp_ids[i]))
            if mp is None or mp.bad:
                frame.mp_ids[i] = -1
                continue
            mp.n_visible += 1
            mp.last_frame_seen = frame.frame_id
            bound_pids.add(mp.pid)

        pool = self.map.pool
        pos = np.zeros((L, 3), np.float32)
        normal = np.zeros((L, 3), np.float32)
        valid = np.zeros(L, bool)
        skip = np.zeros(L, bool)
        rows = np.zeros(L, np.int32)
        n = len(pids)
        if n:
            idx = np.asarray(pids, np.int64)
            pos[:n] = pool.pos[idx]
            rows[:n] = idx
            normal[:n] = pool.normal[idx]
            valid[:n] = True
            skip[:n] = [pid in bound_pids for pid in pids]
        # descriptors: on-device gather from the pool bank (changes only
        # at mapper events — MapPointPool.device_bank), cached across
        # frames while the local-map set and bank are unchanged; in the
        # fleet's bank mode the gather moves into the batched stage
        if bank_desc:
            desc = BankRows(rows, valid, pool.device_bank("desc_track"),
                            pool.bank_version("desc_track"))
        else:
            key = ("desc_track", L, id(pool),
                   pool.bank_version("desc_track"), tuple(pids))
            cached = self._desc_gather_cache.get(("desc_track", L))
            if cached is not None and cached[0] == key:
                desc = cached[1]
            else:
                desc = self.k.gather_rows(
                    pool.device_bank("desc_track"), rows, valid)
                self._desc_gather_cache[("desc_track", L)] = (key, desc)

        kp2mp0 = np.full(frame.K, -1, np.int64)
        for i in np.nonzero(frame.mp_ids >= 0)[0]:
            li = pid_to_local.get(int(frame.mp_ids[i]))
            if li is not None:
                kp2mp0[i] = li
        # (no per-point dmin/dmax: the scale-invariance distance gate is
        # commented out of the reference isInFrustum — kernels.py NOTE — so
        # those arrays were ~32 KB/frame of dead device upload)
        args = (frame.Tcw.astype(np.float32), pos, desc, normal,
                valid, skip, kp2mp0, frame.desc_dev, frame.uv,
                frame.cov2_inv, frame.valid)
        wide = self.map.ba_epoch != self._seen_ba_epoch
        if wide:
            # first frame after a BA write-back: the adjustment moves point
            # projections by ~3 px (seed-2 rail, NOTES r3) — outside the
            # 2.5-4 px window — so search widened immediately instead of
            # collapsing bindings first (reference precedent: the widened
            # window after relocalization, sp_matcher.cpp th parameter)
            self._seen_ba_epoch = self.map.ba_epoch
        return {"pids": pids, "n": n, "args": args, "wide": wide}

    # The fine stage's retry cascade as an explicit state machine, so the
    # fleet can drive every stream's machine in lock-step rounds with ONE
    # batched call per round (slam/fleet.py _fine_retry_rounds) while
    # _track_local_map drives it with immediate dispatch.  Requests are
    # (kind, args) where
    # kind "reloc" runs the multi-start relocalization kernel and every
    # other kind ("wide"/"vel"/"polish") runs local_map_track_wide.

    def _fine_begin(self, frame: FrameData, prep: dict, out: dict) -> dict:
        st = {"frame": frame, "prep": prep, "out": out, "stage": 0,
              "req": None}
        self._fine_advance(st)
        return st

    def _fine_advance(self, st: dict) -> None:
        prep, frame = st["prep"], st["frame"]
        args = prep["args"]
        th = self.cfg.tracking.map.th_ninlier_high
        while True:
            n_in = int(st["out"]["n_inlier"])
            stage, st["stage"] = st["stage"], st["stage"] + 1
            if stage == 0:
                if n_in <= th and not prep["wide"]:
                    # Starvation retry at the widened window (see
                    # local_map_track_wide): local-BA depth slides on
                    # low-parallax points routinely exceed the 4 px window
                    # early in a map's life, and a starved frame forfeits
                    # exactly the constraints BA needs to stop sliding.
                    # Keep whichever result binds more.  (Skipped when the
                    # primary call was already the wide variant.)
                    st["req"] = ("wide", args)
                    return
            elif stage == 1:
                if (n_in < th and self.velocity is not None
                        and self.last_frame is not None
                        and self.last_frame.Tcw is not None):
                    # Pose-candidate arbitration (DEVIATION; no reference
                    # counterpart): the dust coarse aligner can confidently
                    # snap to a neighboring 1/8-grid lattice cell, and the
                    # fine stage then locks onto a small self-consistent
                    # binding subset instead of the map.  Re-run from the
                    # constant-velocity prediction and keep whichever pose
                    # binds more.  The retry drops the coarse stage's
                    # inherited bindings (kp2mp0/skip): the aliased
                    # associations are what drags pose optimization back.
                    Tcw_alt = (self.velocity
                               @ self.last_frame.Tcw).astype(np.float32)
                    st["req"] = ("vel", (
                        Tcw_alt, *args[1:5], np.zeros_like(args[5]),
                        np.full_like(args[6], -1), *args[7:]))
                    return
            elif stage == 2:
                if n_in < th:
                    # Multi-start rescue: the single LM chain is fragile on
                    # a locally-bent map (thin valleys; measured: from an
                    # 11 px-off start one chain kept 24 inliers where a
                    # vmapped start fan found the 103-inlier optimum on the
                    # same matches).  Reuse the relocalization kernel —
                    # brute-force local-map matching + the batched
                    # multi-start optimizer — then polish with a fresh wide
                    # search (the chained "polish" request below).
                    T0s = self._reloc_starts(frame.Tcw)
                    st["req"] = ("reloc", (
                        T0s, args[1], args[2], args[4], frame.desc_dev,
                        frame.uv, frame.cov2_inv, frame.valid))
                    return
            else:
                st["req"] = None
                return

    def _fine_step(self, st: dict, out_new: dict) -> None:
        """Feed one retry result back into the machine: 'reloc' results
        chain into the polishing wide search from the rescued pose; every
        other kind keeps whichever result binds more and advances."""
        kind = st["req"][0]
        if kind == "reloc":
            args = st["prep"]["args"]
            st["req"] = ("polish", (
                np.asarray(out_new["Tcw"], np.float32), *args[1:5],
                np.zeros_like(args[5]), np.full_like(args[6], -1),
                *args[7:]))
            return
        if int(out_new["n_inlier"]) > int(st["out"]["n_inlier"]):
            st["out"] = out_new
        self._fine_advance(st)

    def _dispatch_fine(self, kind: str, rargs) -> dict:
        # per-stream dispatch can inherit fleet-mode BankRows descriptor
        # slots (a machine resumed outside the fleet drive): gather
        rargs = tuple(self.k.gather_rows(a.bank, a.rows, a.valid)
                      if isinstance(a, BankRows) else a for a in rargs)
        if kind == "reloc":
            return self.k.reloc_track(*rargs)
        return self.k.local_map_track_wide(*rargs)

    def fine_begin_fleet(self, frame: FrameData):
        """Fleet phase 2b: start this stream's fine retry machine from the
        batched primary result staged by the fine prepass.  Returns the
        first retry request (for the fleet to batch across streams) or None
        when no retry is needed.  The machine's final best result is
        re-staged so track_frame_fine consumes it without re-running."""
        with self.map.update_lock:
            if self._phase is None or not self._phase[0]:
                return None  # init frame or coarse failed: no fine stage
            staged = self.staged_local
            if staged is None or staged[0] is not frame:
                return None  # the prepass missed this stream
            self._fine_st = self._fine_begin(frame, staged[1], staged[2])
            return self._finish_or_request(frame)

    def fine_step_fleet(self, frame: FrameData, out: dict):
        """Feed one batched retry result back; returns the next request or
        None when the machine finished (result re-staged)."""
        with self.map.update_lock:
            self._fine_step(self._fine_st, out)
            return self._finish_or_request(frame)

    def _finish_or_request(self, frame: FrameData):
        st = self._fine_st
        if st["req"] is not None:
            return st["req"]
        self._fine_st = None
        prep = dict(st["prep"])
        prep["retries_done"] = True
        self.staged_local = (frame, prep, st["out"])
        return None

    def _track_local_map(self, frame: FrameData) -> bool:
        """TrackLocalMap (tracker.cpp:561-615) + SearchLocalPoints (:768)."""
        staged = self.staged_local
        self.staged_local = None
        if staged is not None and staged[0] is frame:
            prep, out = staged[1], staged[2]
        else:
            prep = self.prepare_local_map(frame)
            if prep["wide"]:
                out = self.k.local_map_track_wide(*prep["args"])
            else:
                out = self.k.local_map_track(*prep["args"])
        if not prep.get("retries_done"):
            st = self._fine_begin(frame, prep, out)
            while st["req"] is not None:
                self._fine_step(st, self._dispatch_fine(*st["req"]))
            out = st["out"]
        pids, n, args = prep["pids"], prep["n"], prep["args"]
        # visible bookkeeping (IncreaseVisible on frustum hits, :798-804).
        # Already-bound points (args[5] = the prep-time skip mask) were
        # counted by prepare_local_map; the retry paths zero the skip mask,
        # so without the exclusion a retry frame would credit them twice
        # and drag found_ratio toward the 0.25 culling gate.
        for li in np.nonzero(out["mp_visible"][:n] & ~args[5][:n])[0]:
            mp = self.map.points.get(pids[li])
            if mp is not None:
                mp.n_visible += 1

        kp2mp = out["kp2mp"]
        bound = (kp2mp >= 0) & (kp2mp < n)  # n == 0 -> nothing bindable
        frame.mp_ids[:] = -1
        if n:
            frame.mp_ids[bound] = np.asarray(pids, np.int64)[kp2mp[bound]]
        frame.outlier[:] = False
        frame.outlier[bound & ~out["inlier"]] = True
        frame.set_pose(out["Tcw"])

        self.matches_inliers = 0
        for i in np.nonzero(bound)[0]:
            mp = self.map.get_point(int(frame.mp_ids[i]))
            if mp is None:
                continue
            if not frame.outlier[i]:
                mp.n_found += 1
                # localization mode counts every non-outlier binding; normal
                # mode requires the point to be in the map (tracker.cpp:580-585)
                if self.only_tracking or mp.n_obs > 0:
                    self.matches_inliers += 1
        self.inlier_fine.append(self.matches_inliers)
        self.inlier_fine_ratio.append(
            self.matches_inliers / max(frame.count, 1))

        if self.matches_inliers < self.cfg.tracking.map.th_ninlier_low:
            self.last_fail = (f"local: inliers={self.matches_inliers}"
                              f"<{self.cfg.tracking.map.th_ninlier_low} "
                              f"(n_extra={int(out['n_extra'])}, "
                              f"n_local={n})")
            return False
        return True

    # ------------------------------------------------------------ keyframes

    def _need_new_keyframe(self, frame: FrameData) -> bool:
        """NeedNewKeyFrameOverride (tracker.cpp:617-670)."""
        if self.mapper is not None and self.mapper.stopped:
            return False
        ref = self.map.keyframes.get(self.ref_kf)
        if ref is None:
            return False
        curr_pids = set()
        for i in np.nonzero(frame.mp_ids >= 0)[0]:
            if not frame.outlier[i]:
                mp = self.map.get_point(int(frame.mp_ids[i]))
                if mp is not None and not mp.bad:
                    curr_pids.add(mp.pid)
        n_common, total = self.map.tracked_in_common(ref, curr_pids)
        ratio_in_common = n_common / total
        idle = self.mapper.accepting if self.mapper is not None else True
        t = self.cfg.tracking
        # Offline KF pacing (config.py create_kf_min_gap /
        # create_kf_min_baseline_ratio): gate only the bare-idle creation
        # path; weak-tracking (c1b) and starvation (c3) always pass.
        idle_create = idle
        if idle_create and t.create_kf_min_gap > 0:
            idle_create = (frame.frame_id
                           >= self.last_kf_id_frame + t.create_kf_min_gap)
        if idle_create and t.create_kf_min_baseline_ratio > 0:
            idle_create = (self._baseline_depth_ratio(frame, ref)
                           >= t.create_kf_min_baseline_ratio)
        c1a = frame.frame_id >= self.last_kf_id_frame + self.cfg.camera.fps
        ratio_in_curr = self.matches_inliers / max(frame.count, 1)
        c1b = (ratio_in_common < t.create_kf_tracked_over_ref
               and ratio_in_curr < t.create_kf_tracked_over_curr)
        c2 = ratio_in_common < t.create_kf_ref_ratio
        c3 = self.matches_inliers < t.create_kf_nmatch
        if ((c1a or c1b or idle_create) and c2) or c3:
            if idle:
                return True
            if self.mapper is not None:
                self.mapper.interrupt_ba()
            return bool(c3)
        return False

    def _baseline_depth_ratio(self, frame: FrameData, ref) -> float:
        """Baseline to the reference KF over its scene median depth — the
        same quantity local mapping uses to skip near-zero-baseline pairs
        for triangulation (local_mapper.cpp baseline/medianDepth gate)."""
        Ow_f = -frame.Tcw[:3, :3].T @ frame.Tcw[:3, 3]
        baseline = float(np.linalg.norm(Ow_f - ref.Ow))
        R2, t2 = ref.Tcw[2, :3], ref.Tcw[2, 3]
        zs = sorted(float(R2 @ self.map.pool.pos[pid] + t2)
                    for pid in ref.mp_ids if pid >= 0)
        if not zs:
            return float("inf")
        med = zs[(len(zs) - 1) // 2]
        return float("inf") if med <= 0 else baseline / med

    def _create_keyframe(self, frame: FrameData) -> None:
        """CreateNewKeyFrameOverride (tracker.cpp:744-766)."""
        kf = self.map.add_keyframe(frame)
        self.ref_kf = kf.kf_id
        frame.ref_kf = kf.kf_id
        if self.mapper is not None:
            self.mapper.insert_keyframe(kf.kf_id)
        self.last_kf_id_frame = frame.frame_id

    # ----------------------------------------------------------- trajectory

    def _record_trajectory(self, frame: FrameData) -> None:
        """tracker.cpp:343-356."""
        if frame.Tcw is not None and frame.ref_kf >= 0:
            ref = self.map.keyframes.get(frame.ref_kf)
            if ref is not None:
                Twr = np.linalg.inv(ref.Tcw)
                self.rel_poses.append(frame.Tcw @ Twr)
                self.refs.append(frame.ref_kf)
                self.times.append(frame.timestamp)
                self.lost_flags.append(self.state == LOST)
                return
        if self.rel_poses:
            self.rel_poses.append(self.rel_poses[-1])
            self.refs.append(self.refs[-1])
            self.times.append(frame.timestamp)
            self.lost_flags.append(self.state == LOST)

    def report(self) -> dict:
        """End-of-run tracking summary, field-for-field with the reference's
        shutdown report (tracker.cpp:1149-1188): coarse/fine inlier means,
        the per-N ratios, the fine-inlier spread (the reference prints the
        sqrt of the mean squared deviation under the label "variance" —
        reported here as *_std, plus the actual variance), the dust failure
        total, and the per-gate breakdown the reference logs per-frame
        (tracker_dust.cpp:97-103,174-180,218-227)."""
        fine = np.asarray(self.inlier_fine, np.float64)
        fine_var = float(np.mean((fine - fine.mean()) ** 2)) if fine.size else 0.0
        return dict(
            n_frames=len(self.rel_poses),
            n_fail_dust=self.n_fail_dust,
            fail_dust_stages=dict(self.fail_dust_stages),
            coarse_inliers=float(np.mean(self.inlier_coarse)) if self.inlier_coarse else 0.0,
            coarse_inlier_ratio=float(np.mean(self.inlier_coarse_ratio)) if self.inlier_coarse_ratio else 0.0,
            fine_inliers=float(fine.mean()) if fine.size else 0.0,
            fine_inliers_var=fine_var,
            fine_inliers_std=float(np.sqrt(fine_var)),
            fine_inlier_ratio=float(np.mean(self.inlier_fine_ratio)) if self.inlier_fine_ratio else 0.0,
            n_lost=int(np.sum(self.lost_flags)),
        )
