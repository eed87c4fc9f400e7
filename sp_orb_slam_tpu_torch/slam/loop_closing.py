"""Loop closing with global-descriptor place recognition.

The port of the JAX package's slam/loop_closing.py, a rebuild of
`LoopClosingVLAD` (src/loopclosing/loop_closer_vlad.cpp): the reference
replaces DBoW2 with NetVLAD global descriptors (computed here at keyframe
promotion by models/netvlad.py) and scans the keyframe database by dot
product.

Pipeline (citations into loop_closer_vlad.cpp):
- detect (:120-255): skip if < 10 KFs since the last loop; minScore = min
  dot against covisibles floored at 0.2; candidates above minScore,
  accumulated over their 10 best covisibles, retained at 0.75 x best;
  temporal consistency groups with threshold 3;
- compute_sim3 (:345-502): brute-force match >= 20 -> Sim3 RANSAC
  (0.99, 20, 300) -> guided Sim3 projection matching -> OptimizeSim3 >= 20
  -> project the loop neighborhood's points, accept >= 40 total matches;
- correct_loop (:504-699): propagate Scw to the current covisibles, remap
  their points, fuse matched duplicates, SearchAndFuse over the corrected
  neighborhood, essential-graph optimization, global BA.

The matchers, RANSAC, OptimizeSim3, the pose graph and global BA run on
the system's device; the bookkeeping (scores, consistency groups, the
projection gates, the correction writes) stays float64 numpy on the host
with the JAX package's calls, so tie orders agree.  The JAX package pads
every device input to a static capacity or a power of two to bound XLA
compiles.  The port drops that padding wherever the valid masks make the
result the same (the brute-force matcher, RANSAC, OptimizeSim3, the
projection distances, the batched logs and the pose graph: padded rows
and edges contribute exact zeros, so at most the order of float32 sums
differs) and keeps the keypoint-slot arrays of the Sim3 search, whose
indices are its result.

Offline the System spins the loop closer after each frame and the global
BA runs inline; online `start` runs it on its own thread and each loop's
global BA on a transient third (`_launch_gba`), both on the starting
thread's device and CUDA stream.  `warmup` runs the loop path's device
calls once before the first frame.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Set

import numpy as np
import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.ops import matching
from sp_orb_slam_tpu_torch.optim import sim3 as s3
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels, upload
from sp_orb_slam_tpu_torch.slam.local_mapping import (LocalMapping,
                                                      apply_global_ba_staged,
                                                      assemble_global_ba,
                                                      current_stream,
                                                      enter_device,
                                                      raise_backend_error,
                                                      solve_global_ba)
from sp_orb_slam_tpu_torch.slam.map import KeyFrame, Map

RANSAC_ITERS = 300  # Sim3Solver's (0.99, 20, 300)


def _np_sim3(R, t, s):
    return np.asarray(R, np.float64), np.asarray(t, np.float64), float(s)


def _sim3_mul_np(A, B):
    Ra, ta, sa = A
    Rb, tb, sb = B
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


def _sim3_inv_np(S):
    R, t, s = S
    return R.T, -(1.0 / s) * (R.T @ t), 1.0 / s


def _sim3_apply_np(S, X):
    R, t, s = S
    return s * (X @ R.T) + t


def _stack_sim3(Ss: list):
    """A list of (R, t, s) host Sim3 tuples as float32 arrays."""
    return (np.stack([np.asarray(S[0], np.float32) for S in Ss]),
            np.stack([np.asarray(S[1], np.float32) for S in Ss]),
            np.asarray([S[2] for S in Ss], np.float32))


class LoopClosing:
    def __init__(self, cfg: Config, world: Map, kernels: TrackingKernels,
                 mapper: LocalMapping):
        """Runs its device work on `kernels.device`, the system's."""
        self.cfg = cfg
        self.map = world
        self.k = kernels
        self.device = kernels.device
        self.mapper = mapper
        self.queue = collections.deque()
        self.db: List[int] = []           # keyframe ids with global descs
        self.consistent_groups: List[tuple] = []  # (set(kf_ids), count)
        self.last_loop_kf = -10 ** 9
        self.n_loops_closed = 0
        # (current KF, matched KF) of each closed loop, in order
        self.loops: List[tuple] = []
        # the Sim3 RANSAC sample stream (the JAX package's PRNGKey(271828))
        self._sim3_gen = torch.Generator().manual_seed(271828)
        self._thread = None
        self._shutdown = False
        self._busy = False  # a popped keyframe is being processed
        # what ended the loop or the GBA thread (re-raised by the System)
        self.error: BaseException | None = None
        # transient GBA thread state (mpThreadGBA / mbRunningGBA /
        # mbStopGBA, loop_closer_vlad.h; kill-running-GBA at
        # loop_closer_vlad.cpp:511-529)
        self._gba_thread = None
        self._gba_stop = False
        self.gba_running = False

    def insert_keyframe(self, kf_id: int) -> None:
        self.queue.append(kf_id)

    def _sim3_draws(self, n_valid: int) -> torch.Tensor:
        """The sample positions of one Sim3 RANSAC: (300, 3) uniform
        integers in [0, n_valid) from the looper's generator."""
        return torch.randint(0, max(n_valid, 1), (RANSAC_ITERS, 3),
                             generator=self._sim3_gen)

    # ------------------------------------------------------------------ spin

    def spin_once(self) -> None:
        while True:
            self._busy = True  # before the pop: see drain
            try:
                kf_id = self.queue.popleft()
            except IndexError:
                self._busy = False
                return
            kf = self.map.keyframes.get(kf_id)
            if kf is None or kf.bad or kf.global_desc is None:
                continue
            # detection + Sim3 read the covisibility graph and the point
            # pool: hold the map lock against concurrent mapper surgery
            with self.map.update_lock:
                # pin the current KF (SetNotErase, DetectLoop's entry) so
                # the mapper cannot cull it in the detect -> Sim3 -> correct
                # window; the matched KF is pinned the moment it is known
                kf.not_erase = True
                candidates = self._detect(kf)
                hit = (self._compute_sim3(kf, candidates) if candidates
                       else None)
                if hit is not None:
                    matched = self.map.keyframes.get(hit[0])
                    if matched is not None:
                        matched.not_erase = True
            if hit is None:
                kf.not_erase = False
                continue
            matched_kf, Scw, matches = hit
            try:
                self._correct_loop(kf, matched_kf, Scw, matches)
            finally:
                kf.not_erase = False
                m = self.map.keyframes.get(matched_kf)
                if m is not None:
                    m.not_erase = False

    # ------------------------------------------------------------ thread drive

    def start(self) -> None:
        """Own-thread drive (LoopClosingVLAD::Run, loop_closer_vlad.cpp:
        289-325; spawned at system.cpp:100-106) on the caller's device and
        stream."""
        if self._thread is not None:
            return
        self._shutdown = False
        self._thread = threading.Thread(
            target=self.run, args=(current_stream(self.device),),
            name="loop_closing", daemon=True)
        self._thread.start()

    def run(self, stream=None) -> None:
        """An exception ends the thread and is kept in `error`."""
        try:
            enter_device(self.device, stream)
            while not self._shutdown:
                self.spin_once()
                time.sleep(1e-3)
        except Exception as e:  # re-raised by the System
            self.error = e
        finally:
            self._busy = False

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the queue is empty, no keyframe is in process and no
        global BA runs; raise when `timeout` seconds pass first or when a
        thread of the loop closer died.  Nothing to wait for without a
        thread."""
        t0 = time.monotonic()
        while self.queue or self._busy or self.gba_running:
            raise_backend_error("loop closing", self.error)
            if self._thread is None:
                return
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"loop closing did not drain within {timeout} s "
                    f"({len(self.queue)} keyframes queued, global BA "
                    f"running: {self.gba_running})")
            time.sleep(1e-3)
        raise_backend_error("loop closing", self.error)

    def shutdown(self, timeout: float = 60.0) -> None:
        """End the loop thread and join it, then let a running GBA finish
        and commit (a clean shutdown wants the correction in the exported
        trajectory) and join it; raise when either outlives `timeout`."""
        t = self._thread
        if t is not None:
            self._shutdown = True
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(f"the loop closing thread did not end "
                                   f"within {timeout} s")
            self._thread = None
        g = self._gba_thread
        if g is not None:
            g.join(timeout=timeout)
            if g.is_alive():
                raise TimeoutError(f"the global BA thread did not end "
                                   f"within {timeout} s")
            self._gba_thread = None

    def warmup(self) -> None:
        """Run the loop path's device calls once on dummy inputs at their
        production shapes on the system's device (JAX
        LoopClosing.warmup): one brute-force match, one pairwise distance,
        one Sim3 RANSAC, one OptimizeSim3, one Sim3 projection search and
        one pose-graph solve, so library loads and first-use allocations
        leave the first loop attempt.  The RANSAC draws are zeros: the
        sample stream stays the real attempts'."""
        dev = self.device
        N = self.cfg.runtime.max_keypoints
        K_intr = self.k.K_intr
        z = lambda *shape: torch.zeros(shape, device=dev)
        desc = z(N, 256)
        v = torch.zeros(N, dtype=torch.bool, device=dev)
        v[:32] = True
        matching.search_by_brute_force(desc, v, desc, v).cpu()
        matching.pairwise_dist(z(256, 256), desc).cpu()
        res = s3.sim3_ransac(z(N, 3), z(N, 3), z(N, 2), z(N, 2), v, K_intr,
                             torch.zeros((RANSAC_ITERS, 3), dtype=torch.long))
        res.ok.cpu()
        out = s3.optimize_sim3(
            torch.eye(3, device=dev), z(3), torch.ones((), device=dev),
            z(32, 3), z(32, 3), z(32, 2), z(32, 2),
            torch.ones(32, 2, device=dev), torch.ones(32, 2, device=dev),
            v[:32], K_intr)
        out[4].cpu()
        cam = self.cfg.camera
        bounds = torch.tensor([0.0, cam.width - 1.0, 0.0, cam.height - 1.0],
                              device=dev)
        uv = z(N, 2)
        eye = torch.eye(3, device=dev)
        m1, _ = matching.search_by_sim3(
            z(N, 3), v, desc, z(N), torch.ones(N, device=dev), uv, desc, v,
            z(N, 3), v, desc, z(N), torch.ones(N, device=dev), uv, desc, v,
            eye, z(3), eye, z(3), K_intr, bounds, radius=7.5)
        m1.cpu()
        fixed = torch.ones(8, dtype=torch.bool, device=dev)
        fixed[0] = False
        idx = torch.zeros(8, dtype=torch.long, device=dev)
        out = s3.optimize_pose_graph(
            z(8, 7), fixed, idx, idx, z(8, 7),
            torch.zeros(8, dtype=torch.bool, device=dev), iters=20)
        s3.sim3_exp(out)[2].cpu()

    # ---------------------------------------------------------------- detect

    def _detect(self, kf: KeyFrame) -> List[int]:
        lp = self.cfg.loop
        if kf.kf_id < self.last_loop_kf + lp.kf_gap:
            # too close to the last loop: no detection, but the KF still
            # enters the place-recognition database (the reference's early
            # exit still runs mpKeyFrameDB->add; loop_closer_vlad.cpp:132)
            self.db.append(kf.kf_id)
            self.consistent_groups.clear()
            return []
        connected = set(kf.connections)
        # minScore = min similarity among covisibles, floored (:150-165)
        min_score = 1.0
        for kid in connected:
            other = self.map.keyframes.get(kid)
            if other is None or other.bad or other.global_desc is None:
                continue
            min_score = min(min_score,
                            float(kf.global_desc @ other.global_desc))
        min_score = max(min_score, lp.min_score_floor)

        scores: Dict[int, float] = {}
        for kid in self.db:
            other = self.map.keyframes.get(kid)
            if other is None or other.bad or kid in connected:
                continue
            sc = float(kf.global_desc @ other.global_desc)
            if sc > min_score:
                scores[kid] = sc
        if not scores:
            self.db.append(kf.kf_id)
            self.consistent_groups.clear()
            return []

        # covisibility-accumulated scores + 0.75-best retention (:68-118)
        acc: List[tuple] = []
        best_acc = min_score
        for kid, sc in scores.items():
            other = self.map.keyframes[kid]
            acc_score = sc
            best_kf, best_sc = kid, sc
            for nb in other.best_covisible(10):
                if nb in scores:
                    acc_score += scores[nb]
                    if scores[nb] > best_sc:
                        best_kf, best_sc = nb, scores[nb]
            acc.append((acc_score, best_kf))
            best_acc = max(best_acc, acc_score)
        retained = []
        seen: Set[int] = set()
        for acc_score, kid in acc:
            if acc_score > 0.75 * best_acc and kid not in seen:
                retained.append(kid)
                seen.add(kid)

        # temporal consistency groups (:182-241)
        enough: List[int] = []
        new_groups: List[tuple] = []
        group_used = [False] * len(self.consistent_groups)
        for kid in retained:
            cand_kf = self.map.keyframes[kid]
            group = set(cand_kf.connections) | {kid}
            consistent_any = False
            enough_this = False
            for gi, (prev_group, count) in enumerate(self.consistent_groups):
                if group & prev_group:
                    consistent_any = True
                    if not group_used[gi]:
                        new_groups.append((group, count + 1))
                        group_used[gi] = True
                    if (count + 1 >= lp.covisibility_consistency_th
                            and not enough_this):
                        enough.append(kid)
                        enough_this = True
            if not consistent_any:
                new_groups.append((group, 0))
        self.consistent_groups = new_groups
        self.db.append(kf.kf_id)
        return enough

    # ----------------------------------------------------------- compute sim3

    def _kf_matched_arrays(self, kf: KeyFrame):
        """Rows (kp idx, pid) of the KF's observed keypoints."""
        rows, pids = [], []
        for i, pid in enumerate(kf.mp_ids):
            if pid < 0:
                continue
            mp = self.map.get_point(int(pid))
            if mp is not None and not mp.bad:
                rows.append(i)
                pids.append(mp.pid)
        return rows, pids

    def _compute_sim3(self, kf: KeyFrame, candidates: List[int]):
        dev = self.device
        K_intr = self.k.K_intr
        pool = self.map.pool
        rows1, pids1 = self._kf_matched_arrays(kf)
        if len(rows1) < 20:
            return None
        d1 = kf.data.desc_dev[torch.as_tensor(rows1, device=dev)]
        v1 = torch.ones(len(rows1), dtype=torch.bool, device=dev)
        for kid in candidates:
            cand = self.map.keyframes.get(kid)
            if cand is None or cand.bad:
                continue
            rows2, pids2 = self._kf_matched_arrays(cand)
            if len(rows2) < 20:
                continue
            d2 = cand.data.desc_dev[torch.as_tensor(rows2, device=dev)]
            v2 = torch.ones(len(rows2), dtype=torch.bool, device=dev)
            # mutual-NN brute force (loop variant, sp_matcher_loop.cpp:334)
            m = matching.search_by_brute_force(d2, v2, d1, v1).cpu().numpy()
            pairs = [(i1, int(m[i1])) for i1 in range(len(rows1))
                     if m[i1] >= 0]
            if len(pairs) < 20:
                continue
            # camera-frame 3D points of the matched map points in each KF
            X1 = np.stack([pool.pos[pids1[i1]] for i1, _ in pairs])
            X2 = np.stack([pool.pos[pids2[i2]] for _, i2 in pairs])
            n_p = len(pairs)
            X1c = X1 @ kf.Tcw[:3, :3].T + kf.Tcw[:3, 3]
            X2c = X2 @ cand.Tcw[:3, :3].T + cand.Tcw[:3, 3]
            uv1 = kf.data.uv[[rows1[i1] for i1, _ in pairs]]
            uv2 = cand.data.uv[[rows2[i2] for _, i2 in pairs]]
            res = s3.sim3_ransac(
                *upload((X1c, X2c, uv1, uv2, np.ones(n_p, bool)), dev),
                K_intr, self._sim3_draws(n_p))
            flat = torch.cat([res.R.reshape(-1), res.t, res.s[None],
                              res.ok.float()[None]]).cpu().numpy()
            if flat[13] < 0.5:
                continue
            R0, t0, s0 = flat[:9].reshape(3, 3), flat[9:12], flat[12]
            # guided growth between RANSAC and refinement:
            # SearchBySim3Override projects each KF's unmatched map points
            # through the candidate Sim3 into the other image and keeps
            # mutually agreeing best matches (ComputeSim3's middle step)
            slot_pairs = [(rows1[i1], rows2[i2]) for i1, i2 in pairs]
            grown = self._search_by_sim3(kf, cand, (R0, t0, s0), slot_pairs)
            union = slot_pairs + grown
            # RANSAC aligns X1c (current camera) -> X2c (candidate camera),
            # i.e. S_cand,cur; OptimizeSim3 refines it on the grown set and
            # prunes by chi2 itself
            resolved = []
            for a, b in union:
                mp_a = self.map.get_point(int(kf.mp_ids[a]))
                mp_b = self.map.get_point(int(cand.mp_ids[b]))
                if (mp_a is not None and not mp_a.bad
                        and mp_b is not None and not mp_b.bad):
                    resolved.append((a, b, mp_a.pid, mp_b.pid))
            s1 = np.asarray([r[0] for r in resolved], np.int64)
            s2 = np.asarray([r[1] for r in resolved], np.int64)
            p1 = np.asarray([r[2] for r in resolved], np.int64)
            p2 = np.asarray([r[3] for r in resolved], np.int64)
            Xu1 = pool.pos[p1] @ kf.Tcw[:3, :3].T + kf.Tcw[:3, 3]
            Xu2 = pool.pos[p2] @ cand.Tcw[:3, :3].T + cand.Tcw[:3, 3]
            R, t, s_, _, n_inl = s3.optimize_sim3(
                *upload((R0, t0, s0, Xu1, Xu2, kf.data.uv[s1],
                         cand.data.uv[s2], kf.data.cov2_inv[s1],
                         cand.data.cov2_inv[s2],
                         np.ones(len(resolved), bool)), dev), K_intr)
            flat = torch.cat([R.reshape(-1), t, s_[None],
                              n_inl.float()[None]]).cpu().numpy()
            if int(flat[13]) < 20:
                continue
            S_cand_cur = _np_sim3(flat[:9].reshape(3, 3), flat[9:12],
                                  flat[12])
            S_cur_cand = _sim3_inv_np(S_cand_cur)
            # Scw = Scm * Smw (:437-441), m = matched/candidate KF
            Smw = (cand.Tcw[:3, :3].astype(np.float64),
                   cand.Tcw[:3, 3].astype(np.float64), 1.0)
            Scw = _sim3_mul_np(S_cur_cand, Smw)

            # project the loop neighborhood's map points into the current KF
            loop_pids = []
            seen = set()
            for nk in cand.best_covisible(200) + [cand.kf_id]:
                nkf = self.map.keyframes.get(nk)
                if nkf is None or nkf.bad:
                    continue
                for pid in nkf.mp_ids:
                    if pid >= 0 and pid not in seen:
                        mp = self.map.get_point(int(pid))
                        if mp is not None and not mp.bad:
                            seen.add(int(pid))
                            loop_pids.append(mp.pid)
            matches = self._project_match(kf, Scw, loop_pids, radius=10.0)
            if len(matches) >= 40:
                return cand.kf_id, Scw, (matches, loop_pids)
        return None

    def _search_by_sim3(self, kf: KeyFrame, cand: KeyFrame, S,
                        slot_pairs) -> List[tuple]:
        """Host side of SearchBySim3Override (sp_matcher_loop.cpp:7-220):
        per-keypoint-slot arrays for both keyframes, the mutual Sim3
        projection search on the device, and the agreeing new (slot1,
        slot2) pairs (:211-223).  `S` is the RANSAC Sim3 S_cand<-cur."""
        matched1 = {a for a, _ in slot_pairs}
        matched2 = {b for _, b in slot_pairs}
        N = self.cfg.runtime.max_keypoints

        def slot_arrays(kf_, exclude):
            pool = self.map.pool
            pos_c = np.zeros((N, 3), np.float32)
            desc = np.zeros((N, 256), np.float32)
            dmin = np.zeros(N, np.float32)
            dmax = np.full(N, 1e9, np.float32)
            ok = np.zeros(N, bool)
            R, t = kf_.Tcw[:3, :3], kf_.Tcw[:3, 3]
            for i, pid in enumerate(kf_.mp_ids):
                if pid < 0 or i in exclude:
                    continue
                mp = self.map.get_point(int(pid))
                if mp is None or mp.bad:
                    continue
                pos_c[i] = pool.pos[mp.pid] @ R.T + t
                desc[i] = pool.desc[mp.pid]
                # scale-invariance bounds incl. the 0.8/1.2 margins
                dmin[i] = 0.8 * pool.min_dist[mp.pid]
                dmax[i] = 1.2 * pool.max_dist[mp.pid]
                ok[i] = True
            return pos_c, ok, desc, dmin, dmax

        pos1, ok1, desc1, dmin1, dmax1 = slot_arrays(kf, matched1)
        pos2, ok2, desc2, dmin2, dmax2 = slot_arrays(cand, matched2)

        # S = S_cand<-cur: forward (current map points into image 2) uses
        # it directly, backward its inverse
        Rr = np.asarray(S[0], np.float64)
        tr = np.asarray(S[1], np.float64)
        sr = float(S[2])
        sR21 = (sr * Rr).astype(np.float32)
        t21 = tr.astype(np.float32)
        sR12 = ((1.0 / sr) * Rr.T).astype(np.float32)
        t12 = (-(1.0 / sr) * (Rr.T @ tr)).astype(np.float32)

        cam = self.cfg.camera
        bounds = np.array([0.0, cam.width - 1.0, 0.0, cam.height - 1.0],
                          np.float32)
        a = upload((pos1, ok1, desc1, dmin1, dmax1, kf.data.uv,
                    kf.data.valid, pos2, ok2, desc2, dmin2, dmax2,
                    cand.data.uv, cand.data.valid, sR21, t21, sR12, t12,
                    bounds), self.device)
        m1, m2 = matching.search_by_sim3(
            *a[0:6], kf.data.desc_dev, a[6], *a[7:13], cand.data.desc_dev,
            a[13], *a[14:18], self.k.K_intr, a[18], radius=7.5)
        m12 = torch.cat([m1, m2]).cpu().numpy()
        m1, m2 = m12[:N], m12[N:]
        grown = []
        for s1_ in np.nonzero(m1 >= 0)[0]:
            s2_ = int(m1[s1_])
            if m2[s2_] == s1_:
                grown.append((int(s1_), s2_))
        return grown

    def _project_match(self, kf: KeyFrame, Scw, pids: List[int],
                       radius: float) -> Dict[int, int]:
        """SearchByProjectionLoop (sp_matcher_loop.cpp:222-332) / the Fuse
        Sim3 overload (sp_matcher.cpp:1106-1219): project map points
        through Scw into the KF with the reference's geometric gates
        (positive depth, in-image, the scale-invariance depth range
        0.8*dmin / 1.2*dmax, sp_matcher.cpp:1159-1165, and a viewing angle
        < 60 deg, PO . normal >= 0.5 * |PO|, :1168-1171), then the best
        descriptor within the window at TH_HIGH (:1204).  Returns
        {kp_idx: pid}."""
        if not pids:
            return {}
        pool = self.map.pool
        idx = np.asarray(pids, np.int64)
        Xw = pool.pos[idx].astype(np.float64)
        Xc = _sim3_apply_np(Scw, Xw)
        z = Xc[:, 2]
        ok = z > 0
        K = self.k.K_np
        u = K[0] * Xc[:, 0] / np.where(ok, z, 1.0) + K[2]
        v = K[1] * Xc[:, 1] / np.where(ok, z, 1.0) + K[3]
        cam = self.cfg.camera
        ok &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        # depth-range + viewing-angle gates against the Sim3 camera center
        # Ow = -Rcw^T tcw with Rcw = sR/s, tcw = t/s (sp_matcher.cpp:
        # 1119-1121)
        Rs, ts, ss = Scw
        Ow = -(np.asarray(Rs, np.float64).T
               @ (np.asarray(ts, np.float64) / ss))
        PO = Xw - Ow[None, :]
        dist3 = np.linalg.norm(PO, axis=1)
        ok &= ((dist3 >= 0.8 * pool.min_dist[idx])
               & (dist3 <= 1.2 * pool.max_dist[idx]))
        cosang = np.einsum('ij,ij->i', PO,
                           pool.normal[idx].astype(np.float64))
        ok &= cosang >= 0.5 * dist3
        proj = np.stack([u, v], -1).astype(np.float32)
        descp = torch.from_numpy(pool.desc[idx]).to(self.device)
        dist = matching.pairwise_dist(descp, kf.data.desc_dev).cpu().numpy()
        du = np.abs(kf.data.uv[None, :, 0] - proj[:, None, 0])
        dv = np.abs(kf.data.uv[None, :, 1] - proj[:, None, 1])
        mask = ((du < radius) & (dv < radius) & ok[:, None]
                & kf.data.valid[None, :])
        d = np.where(mask, dist, 1e9)
        best_kp = d.argmin(axis=1)
        best_d = d.min(axis=1)
        matches: Dict[int, int] = {}
        order = np.argsort(best_d)
        used = set()
        for pi in order:
            if best_d[pi] > matching.TH_HIGH:
                break
            kp = int(best_kp[pi])
            if kp in used:
                continue
            used.add(kp)
            matches[kp] = pids[pi]
        return matches

    # ------------------------------------------------------------- correction

    def _correct_loop(self, kf: KeyFrame, matched_kf_id: int, Scw,
                      hit) -> None:
        # CorrectLoop (loop_closer_vlad.cpp:504-699): stop any running GBA
        # first (its commit drives its own stop/release cycle on the
        # mapper), freeze the mapper (RequestStop, :511-518), do the map
        # surgery under the map-update lock (:543-639), release the mapper,
        # then run global BA (:681-690)
        self._stop_gba()
        self.mapper.stop()
        try:
            with self.map.update_lock:
                self._correct_loop_locked(kf, matched_kf_id, Scw, hit)
        finally:
            self.mapper.release()
        self._launch_gba(kf.kf_id)

    # ------------------------------------------------------- transient GBA

    def _stop_gba(self, timeout: float = 60.0) -> None:
        """Kill a running GBA (mbStopGBA + join; loop_closer_vlad.cpp:
        520-529).  The device solve itself is not interruptible, but its
        result is discarded at the commit check."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            self._gba_stop = True
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(f"the global BA thread did not end "
                                   f"within {timeout} s")
        self._gba_thread = None
        self._gba_stop = False

    def _launch_gba(self, loop_kf_id: int) -> None:
        """Spawn RunGlobalBundleAdjustment (loop_closer_vlad.cpp:687) on
        its own thread, on this thread's device and stream, when the loop
        closer runs on its own thread; the offline deterministic drive runs
        the same staged code path inline."""
        self.gba_running = True
        self._gba_stop = False
        if self._thread is not None:
            self._gba_thread = threading.Thread(
                target=self._gba_main,
                args=(loop_kf_id, current_stream(self.device)),
                name="global_ba", daemon=True)
            self._gba_thread.start()
        else:
            try:
                self._run_gba(loop_kf_id)
            finally:
                self.gba_running = False

    def _gba_main(self, loop_kf_id: int, stream) -> None:
        """The GBA thread: an exception ends it and is kept in `error`
        (before `gba_running` falls, so `drain` cannot miss it)."""
        try:
            enter_device(self.device, stream)
            self._run_gba(loop_kf_id)
        except Exception as e:  # re-raised by the System
            self.error = e
        finally:
            self.gba_running = False

    def _run_gba(self, loop_kf_id: int) -> None:
        """RunGlobalBundleAdjustment (loop_closer_vlad.cpp:753-849):
        snapshot under the lock, solve outside it, then stop the mapper and
        commit with spanning-tree propagation to keyframes and points
        created during the solve."""
        with self.map.update_lock:
            problem = assemble_global_ba(self.map)
        res = solve_global_ba(problem, self.k, iters=10)
        if self._gba_stop:
            return
        self.mapper.stop()
        try:
            with self.map.update_lock:
                if self._gba_stop:
                    return
                apply_global_ba_staged(self.map, problem, res, loop_kf_id)
        finally:
            self.mapper.release()

    def _correct_loop_locked(self, kf: KeyFrame, matched_kf_id: int, Scw,
                             hit) -> None:
        matches, loop_pids = hit
        world = self.map
        world.update_connections(kf)

        connected = [kf.kf_id] + [k for k in kf.connections
                                  if not world.keyframes[k].bad]
        Twc = np.linalg.inv(kf.Tcw).astype(np.float64)

        corrected: Dict[int, tuple] = {kf.kf_id: Scw}
        non_corrected: Dict[int, tuple] = {}
        for kid in connected:
            kfi = world.keyframes[kid]
            Tiw = kfi.Tcw.astype(np.float64)
            Siw = (Tiw[:3, :3], Tiw[:3, 3], 1.0)
            non_corrected[kid] = Siw
            if kid != kf.kf_id:
                Tic = Tiw @ Twc
                Sic = (Tic[:3, :3], Tic[:3, 3], 1.0)
                corrected[kid] = _sim3_mul_np(Sic, Scw)

        # remap points of the current neighborhood + set corrected poses
        remapped: Set[int] = set()
        for kid, Siw_corr in corrected.items():
            kfi = world.keyframes[kid]
            Swi_corr = _sim3_inv_np(Siw_corr)
            Siw_old = non_corrected[kid]
            for pid in kfi.mp_ids:
                if pid < 0 or pid in remapped:
                    continue
                mp = world.get_point(int(pid))
                if mp is None or mp.bad:
                    continue
                remapped.add(int(pid))
                P = world.pool.pos[mp.pid].astype(np.float64)
                world.pool.pos[mp.pid] = _sim3_apply_np(
                    Swi_corr, _sim3_apply_np(Siw_old, P)).astype(np.float32)
                world.update_normal_and_depth(mp)
            R, t, s_ = Siw_corr
            Tcorr = np.eye(4, dtype=np.float32)
            Tcorr[:3, :3] = R
            Tcorr[:3, 3] = (np.asarray(t) / s_)
            kfi.set_pose(Tcorr)
            world.update_connections(kfi)

        # fuse the matched loop points into the current KF (:625-639)
        for kp_idx, pid in matches.items():
            loop_mp = world.get_point(pid)
            if loop_mp is None or loop_mp.bad:
                continue
            cur_pid = int(kf.mp_ids[kp_idx])
            if cur_pid >= 0:
                cur_mp = world.get_point(cur_pid)
                if (cur_mp is not None and not cur_mp.bad
                        and cur_mp.pid != loop_mp.pid):
                    world.replace_point(cur_mp, loop_mp)
            else:
                world.add_observation(loop_mp, kf.kf_id, kp_idx)
                world.compute_distinctive_descriptor(loop_mp)

        # snapshot the pre-fusion covisibility before any cross-loop
        # observations land (vpPreviousNeighbors, loop_closer_vlad.cpp:
        # 641-668), so the diff below isolates the edges fusion created
        prev_neighbors = {kid: set(world.keyframes[kid].ordered_neighbors)
                          for kid in connected}

        # SearchAndFuse: project loop points into every corrected KF
        # (:701-726)
        for kid in corrected:
            kfi = world.keyframes[kid]
            m2 = self._project_match(kfi, corrected[kid], loop_pids,
                                     radius=4.0)
            for kp_idx, pid in m2.items():
                loop_mp = world.get_point(pid)
                if loop_mp is None or loop_mp.bad:
                    continue
                cur_pid = int(kfi.mp_ids[kp_idx])
                if cur_pid >= 0 and cur_pid != loop_mp.pid:
                    cur_mp = world.get_point(cur_pid)
                    if cur_mp is not None and not cur_mp.bad:
                        world.replace_point(cur_mp, loop_mp)
                elif cur_pid < 0:
                    world.add_observation(loop_mp, kfi.kf_id, kp_idx)

        # new cross-loop covisibility links
        loop_connections: Dict[int, Set[int]] = {}
        for kid in connected:
            kfi = world.keyframes[kid]
            world.update_connections(kfi)
            loop_connections[kid] = (set(kfi.connections)
                                     - prev_neighbors[kid]
                                     - set(connected))

        self._essential_graph(kf, matched_kf_id, corrected, non_corrected,
                              loop_connections)

        kf.loop_edges.add(matched_kf_id)
        world.keyframes[matched_kf_id].loop_edges.add(kf.kf_id)

        # global BA is not run here: _correct_loop runs it after releasing
        # the map lock (the reference never holds mMutexMapUpdate across
        # GBA either)
        self.last_loop_kf = kf.kf_id
        self.n_loops_closed += 1
        self.loops.append((kf.kf_id, matched_kf_id))

    def _essential_graph(self, kf: KeyFrame, matched_kf_id: int,
                         corrected: Dict[int, tuple],
                         non_corrected: Dict[int, tuple],
                         loop_connections: Dict[int, Set[int]]) -> None:
        """OptimizeEssentialGraph (optimizer.cpp:776-1060).

        Nodes start from the corrected Sim3 where there is one; spanning
        tree and covisibility edges measure from the non-corrected
        (pre-loop) poses, so the odometry chain is the measurement and the
        optimizer distributes the loop correction along it.  Loop
        connections measure from the corrected poses that created them."""
        world = self.map
        dev = self.device
        kfs = sorted(k for k, v in world.keyframes.items() if not v.bad)
        index = {k: i for i, k in enumerate(kfs)}
        N = len(kfs)

        old_sim3: Dict[int, tuple] = {}   # node init (corrected if present)
        meas_sim3: Dict[int, tuple] = {}  # edge-measurement source
        node_S = [None] * N
        for k, i in index.items():
            kfi = world.keyframes[k]
            T = kfi.Tcw.astype(np.float64)
            S_pose = (T[:3, :3], T[:3, 3], 1.0)
            S = corrected.get(k, S_pose)
            old_sim3[k] = S
            meas_sim3[k] = non_corrected.get(k, S_pose)
            node_S[i] = S

        edges = []   # (i, j, meas Sim3)
        added = set()

        def add_edge(ki, kj, Sji):
            key = (min(ki, kj), max(ki, kj))
            if key in added or ki not in index or kj not in index:
                return
            added.add(key)
            edges.append((index[ki], index[kj], Sji))

        def measured(ki, kj, source):
            return _sim3_mul_np(source[kj], _sim3_inv_np(source[ki]))

        # loop-closure connections (the reference gates at minFeat 100
        # except the primary pair)
        for ki, conns in loop_connections.items():
            for kj in conns:
                w = world.keyframes[ki].connections.get(kj, 0)
                if w >= 100 or (ki == kf.kf_id and kj == matched_kf_id):
                    add_edge(ki, kj, measured(ki, kj, old_sim3))
        add_edge(kf.kf_id, matched_kf_id,
                 measured(kf.kf_id, matched_kf_id, old_sim3))
        # spanning tree + loop edges + strong covisibility: measured from
        # the pre-correction odometry
        for k in kfs:
            kfi = world.keyframes[k]
            if kfi.parent >= 0 and kfi.parent in index:
                add_edge(k, kfi.parent, measured(k, kfi.parent, meas_sim3))
            for le in kfi.loop_edges:
                add_edge(k, le, measured(k, le, meas_sim3))
            for kj, w in kfi.connections.items():
                if w >= 100:
                    add_edge(k, kj, measured(k, kj, meas_sim3))

        if not edges:
            return
        fixed = np.zeros(N, bool)
        fixed[index[matched_kf_id]] = True  # loop KF fixed (optimizer.cpp:826)
        Rn, tn, sn = _stack_sim3(node_S)
        Re, te, se = _stack_sim3([e[2] for e in edges])
        (Rn, tn, sn, Re, te, se, fixed_d, ei, ej) = upload(
            (Rn, tn, sn, Re, te, se, fixed,
             np.asarray([e[0] for e in edges], np.int64),
             np.asarray([e[1] for e in edges], np.int64)), dev)
        out = s3.optimize_pose_graph(
            s3.sim3_log(Rn, tn, sn), fixed_d, ei, ej, s3.sim3_log(Re, te, se),
            torch.ones(len(edges), dtype=torch.bool, device=dev), iters=20)
        Rb, tb, sb = s3.sim3_exp(out)
        flat = torch.cat([Rb.reshape(-1), tb.reshape(-1), sb]).cpu().numpy()
        Rb = flat[:N * 9].reshape(N, 3, 3)
        tb = flat[N * 9:N * 12].reshape(N, 3)
        sb = flat[N * 12:]

        # write back: poses [R t/s] and point remap through the old Sim3
        remapped: Set[int] = set()
        for k, i in index.items():
            kfi = world.keyframes[k]
            Rn_ = Rb[i].astype(np.float64)
            tn_ = tb[i].astype(np.float64)
            sn_ = float(sb[i])
            S_new = (Rn_, tn_, sn_)
            S_old = old_sim3[k]
            # remap this KF's points: X <- S_new^-1 (S_old X)
            for pid in kfi.mp_ids:
                if pid < 0 or pid in remapped:
                    continue
                mp = world.get_point(int(pid))
                if mp is None or mp.bad:
                    continue
                remapped.add(int(pid))
                P = world.pool.pos[mp.pid].astype(np.float64)
                world.pool.pos[mp.pid] = _sim3_apply_np(
                    _sim3_inv_np(S_new),
                    _sim3_apply_np(S_old, P)).astype(np.float32)
                world.update_normal_and_depth(mp)
            Tn = np.eye(4, dtype=np.float32)
            Tn[:3, :3] = Rn_
            Tn[:3, 3] = tn_ / sn_
            kfi.set_pose(Tn)
