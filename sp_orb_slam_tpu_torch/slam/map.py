"""Map data model: map points, keyframes, covisibility graph.

Host-side rebuild of the reference core types (type/mappoint.{h,cpp},
type/keyframe.{h,cpp}, type/map.{h,cpp}) with arrays instead of pointer
graphs: map points live in contiguous numpy pools (positions, descriptors,
normals) so per-frame device uploads are cheap slices, while the structural
graph (observations, covisibility, spanning tree) stays in plain dicts.
One map-wide re-entrant lock (`Map.update_lock`, mMutexMapUpdate)
serializes tracking's drives, the mapper's map-mutating stages and loop
detection and correction; in the online mode they run on their own
threads and contend for it.

The port keeps its own copy of the JAX package's slam/map.py; the device
descriptor banks are torch tensors on the system's device.  Keyframes
carry the loop-closing state (loop edges, the erase pin, the staged
global-BA poses), and `Map.global_desc_fn` is the place-recognition hook
run at keyframe promotion.

Semantics reproduced (citations):
- distinctive descriptor = observation descriptor minimizing the median L2
  distance to the others (mappoint.cpp:237-300);
- desc_track = descriptor of the most recent KF observation
  (mappoint.cpp:79-87), consumed by dust/motion tracking;
- UpdateNormalAndDepth: mean unit view ray; max/min scale-invariance
  distance from the reference-KF depth (single-level pyramid -> min == max)
  (mappoint.cpp:322-362); frustum gate uses [0.8 min, 1.2 max];
- found/visible ratio culling at 0.25 (local_mapper.cpp:281-310);
- covisibility edges at weight >= 15 with best-edge fallback, ordered
  neighbor lists, spanning-tree parent = best covisible at first connection
  (keyframe.cpp:757-860);
- SetBadFlag with spanning-tree re-parenting over the covisibility weights
  (keyframe.cpp SetBadFlag);
- MapPoint::Replace observation merge (mappoint.cpp Replace).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sp_orb_slam_tpu_torch.slam.frame import FrameData, orthonormalized_pose

COVIS_TH = 15  # keyframe.cpp:805
# Pool slots of dead points are quarantined for this many tracked frames
# before reuse.  The reference leaks dead MapPoints (raw pointers stay
# valid forever); with a slot pool, immediate reuse would let stale pid
# holders (the tracker's last-frame bindings, a loop-closing candidate
# window) silently resolve to an unrelated new point.  Holders are all
# refreshed within a frame or two; 4 gives margin.  Longer-lived snapshots
# (local/global BA solves) are protected by identity checks instead.
GRAVEYARD_EPOCHS = 4


class MapPointPool:
    """Fixed-capacity numpy pools for map-point array data.

    The two descriptor matrices also keep lazy DEVICE mirrors ("banks"):
    descriptors are the largest per-frame kernel input and change only at
    mapper events (update_desc_track / compute_distinctive_descriptor), so
    they are not re-uploaded per frame.  Writers go through
    write_desc / write_desc_track so dirty rows are tracked; device_bank()
    copies the dirty rows in one scatter and returns the mirror, and the
    tracking kernels gather their point rows from it on the device
    (TrackingKernels.gather_rows)."""

    def __init__(self, capacity: int, desc_dim: int = 256,
                 device: str | torch.device = "cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.pos = np.zeros((capacity, 3), np.float32)
        self.desc_track = np.zeros((capacity, desc_dim), np.float32)
        self.desc = np.zeros((capacity, desc_dim), np.float32)
        self.normal = np.zeros((capacity, 3), np.float32)
        self.min_dist = np.zeros(capacity, np.float32)
        self.max_dist = np.zeros(capacity, np.float32)
        self.alive = np.zeros(capacity, bool)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._banks = {}                       # name -> device tensor
        self._dirty = {"desc_track": set(), "desc": set()}
        self._bank_version = {"desc_track": 0, "desc": 0}

    def invalidate_banks(self) -> None:
        """Drop the device mirrors (bulk host rewrite, e.g. map load)."""
        self._banks.clear()
        for d in self._dirty.values():
            d.clear()
        for k in self._bank_version:
            self._bank_version[k] += 1

    def write_desc(self, pid: int, row: np.ndarray) -> None:
        self.desc[pid] = row
        self._dirty["desc"].add(int(pid))

    def write_desc_track(self, pid: int, row: np.ndarray) -> None:
        self.desc_track[pid] = row
        self._dirty["desc_track"].add(int(pid))

    def bank_version(self, name: str) -> int:
        """Monotone per-bank counter; bumps on every flush (device_bank
        callers key gather caches on it).  Dirty-but-unflushed rows are
        made visible by counting them in."""
        return self._bank_version[name] + (1 if self._dirty[name] else 0)

    def device_bank(self, name: str) -> torch.Tensor:
        """Flush dirty rows and return the (capacity, 256) device mirror.
        The first call starts from device zeros and flushes every live row;
        later calls upload only the rows written since."""
        host = getattr(self, name)
        bank = self._banks.get(name)
        dirty = self._dirty[name]
        if bank is None:
            bank = torch.zeros(host.shape, dtype=torch.float32,
                               device=self.device)
            dirty.clear()
            dirty.update(int(i) for i in np.nonzero(self.alive)[0])
        if dirty:
            idx = np.fromiter(dirty, np.int64, len(dirty))
            rows = torch.from_numpy(host[idx]).to(self.device)
            bank.index_copy_(0, torch.from_numpy(idx).to(self.device), rows)
            dirty.clear()
            self._bank_version[name] += 1
        self._banks[name] = bank
        return bank

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("map point pool exhausted; raise capacity")
        idx = self._free.pop()
        self.alive[idx] = True
        return idx

    def release(self, idx: int) -> None:
        if self.alive[idx]:
            self.alive[idx] = False
            self._free.append(idx)


@dataclass
class MapPoint:
    """Structural per-point state; array data lives in the pool at `pid`."""

    pid: int
    first_kf: int
    # kf_id -> keypoint index
    obs: Dict[int, int] = field(default_factory=dict)
    n_visible: int = 1
    n_found: int = 1
    bad: bool = False
    replaced_by: int = -1
    ref_kf: int = -1
    # per-frame tracking scratch (reference: mnTrackReferenceForFrame etc.)
    track_ref_frame: int = -1
    track_ref_dust: int = -1
    last_frame_seen: int = -1
    fuse_candidate_for: int = -1
    # dust-tracking viz/state (mappoint.h:93-109)
    in_view: bool = False
    dust_match: bool = False

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)


class KeyFrame:
    """A frozen FrameData + covisibility/spanning-tree node."""

    def __init__(self, kf_id: int, frame: FrameData):
        self.kf_id = kf_id
        self.frame_id = frame.frame_id
        self.timestamp = frame.timestamp
        self.data = frame.clone_bindings()
        self.Tcw = orthonormalized_pose(frame.Tcw)
        self.mp_ids = frame.mp_ids.copy()
        self.bad = False
        # loop-closing pin (SetNotErase/SetErase, keyframe.cpp): while set,
        # keyframe culling skips this keyframe, so the detect -> Sim3 ->
        # correct window cannot lose the current or matched keyframe
        self.not_erase = False
        # covisibility
        self.connections: Dict[int, int] = {}   # kf_id -> weight
        self.ordered_neighbors: List[int] = []  # by weight desc
        self.parent: int = -1
        self.children: set = set()
        self.first_connection = True
        self.loop_edges: set = set()
        self.global_desc: Optional[np.ndarray] = frame.global_desc
        # staged global-BA results (optimizer.cpp mTcwGBA / mTcwBefGBA),
        # committed by local_mapping.apply_global_ba_staged
        self.Tcw_gba: Optional[np.ndarray] = None
        self.Tcw_bef_gba: Optional[np.ndarray] = None
        self.ba_global_for = -1

    @property
    def Ow(self) -> np.ndarray:
        return -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]

    def set_pose(self, Tcw: np.ndarray) -> None:
        # SO(3)-projected storage, like g2o's quaternion-backed vertices
        # (see frame.orthonormalized_pose)
        self.Tcw = orthonormalized_pose(Tcw)

    def best_covisible(self, n: int) -> List[int]:
        return self.ordered_neighbors[:n]


class Map:
    """Global map: keyframes + map points + the pools."""

    def __init__(self, mp_capacity: int = 65536,
                 device: str | torch.device = "cpu"):
        self.pool = MapPointPool(mp_capacity, device=device)
        self.points: Dict[int, MapPoint] = {}
        self.keyframes: Dict[int, KeyFrame] = {}
        self.next_kf_id = 0
        self.kf_origin: int = -1
        # the map-update lock (mMutexMapUpdate, map.h:70-74), held by loop
        # detection and correction (loop_closer_vlad.cpp:545)
        self.update_lock = threading.RLock()
        # optional FrameData -> (D,) global-descriptor callable run at
        # keyframe promotion (add_keyframe); None = descriptors come from
        # the dataset only
        self.global_desc_fn = None
        # bumped on every BA write-back: the tracker widens its local-map
        # search window for the first frame after a map adjustment
        self.ba_epoch = 0
        # deferred pool reclamation (see GRAVEYARD_EPOCHS): (epoch, pid)
        # of retired points, flushed by advance_epoch()
        self.frame_epoch = 0
        self._graveyard: List[tuple] = []

    # -- map points ---------------------------------------------------------

    def _retire(self, pid: int) -> None:
        """Quarantine a dead point's pool slot instead of freeing it: the
        slot (and its tombstone in self.points, needed for replaced_by
        chain resolution) survives GRAVEYARD_EPOCHS tracked frames so any
        stale pid holder observes bad/replaced instead of a reused slot."""
        self._graveyard.append((self.frame_epoch, pid))

    def advance_epoch(self) -> None:
        """Per tracked frame (called by the tracker):
        release quarantined slots older than GRAVEYARD_EPOCHS."""
        self.frame_epoch += 1
        cutoff = self.frame_epoch - GRAVEYARD_EPOCHS
        while self._graveyard and self._graveyard[0][0] <= cutoff:
            _, pid = self._graveyard.pop(0)
            mp = self.points.get(pid)
            if mp is not None and (mp.bad or mp.replaced_by >= 0):
                del self.points[pid]
            self.pool.release(pid)

    def create_point(self, pos: np.ndarray, ref_kf: int) -> MapPoint:
        pid = self.pool.alloc()
        self.pool.pos[pid] = pos
        mp = MapPoint(pid=pid, first_kf=ref_kf, ref_kf=ref_kf)
        self.points[pid] = mp
        return mp

    def get_point(self, pid: int) -> Optional[MapPoint]:
        """Resolve through replacement chains (MapPoint::GetReplaced)."""
        mp = self.points.get(pid)
        while mp is not None and mp.replaced_by >= 0:
            mp = self.points.get(mp.replaced_by)
        return mp

    def add_observation(self, mp: MapPoint, kf_id: int, idx: int) -> None:
        if kf_id not in mp.obs:
            mp.obs[kf_id] = idx
            self.keyframes[kf_id].mp_ids[idx] = mp.pid

    def erase_observation(self, mp: MapPoint, kf_id: int) -> None:
        idx = mp.obs.pop(kf_id, None)
        if idx is not None:
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.mp_ids[idx] == mp.pid:
                kf.mp_ids[idx] = -1
        if mp.ref_kf == kf_id and mp.obs:
            mp.ref_kf = next(iter(mp.obs))
        # SetBadFlag when <= 2 observations (mappoint.cpp EraseObservation)
        if mp.n_obs <= 2:
            self.set_point_bad(mp)

    def set_point_bad(self, mp: MapPoint) -> None:
        if mp.bad:
            return
        mp.bad = True
        for kf_id, idx in list(mp.obs.items()):
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.mp_ids[idx] == mp.pid:
                kf.mp_ids[idx] = -1
        mp.obs.clear()
        self._retire(mp.pid)

    def replace_point(self, mp: MapPoint, rep: MapPoint) -> None:
        """MapPoint::Replace (mappoint.cpp): move observations to `rep`."""
        if mp.pid == rep.pid:
            return
        obs = dict(mp.obs)
        mp.bad = True
        mp.obs.clear()
        mp.replaced_by = rep.pid
        for kf_id, idx in obs.items():
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            if kf_id not in rep.obs:
                rep.obs[kf_id] = idx
                kf.mp_ids[idx] = rep.pid
            else:
                kf.mp_ids[idx] = -1
        rep.n_found += mp.n_found
        rep.n_visible += mp.n_visible
        self.compute_distinctive_descriptor(rep)
        self._retire(mp.pid)

    def compute_distinctive_descriptor(self, mp: MapPoint) -> None:
        """mappoint.cpp:237-300 — min-median-distance observation desc."""
        descs = []
        for kf_id, idx in mp.obs.items():
            kf = self.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                descs.append(kf.data.desc_host[idx])
        if not descs:
            return
        D = np.stack(descs)
        dist = np.linalg.norm(D[:, None, :] - D[None, :, :], axis=-1)
        medians = np.median(dist, axis=1)
        self.pool.write_desc(mp.pid, D[int(np.argmin(medians))])

    def update_desc_track(self, mp: MapPoint, kf_id: int, idx: int) -> None:
        """mappoint.cpp:79-87 — descriptor of the latest KF observation."""
        kf = self.keyframes.get(kf_id)
        if kf is not None:
            self.pool.write_desc_track(mp.pid, kf.data.desc_host[idx])

    def update_normal_and_depth(self, mp: MapPoint) -> None:
        """mappoint.cpp:322-362 (single-level pyramid: min == max dist)."""
        if not mp.obs:
            return
        pos = self.pool.pos[mp.pid]
        normal = np.zeros(3, np.float32)
        for kf_id in mp.obs:
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            ray = pos - kf.Ow
            n = np.linalg.norm(ray)
            if n > 1e-12:
                normal += ray / n
        ref = self.keyframes.get(mp.ref_kf) or self.keyframes.get(next(iter(mp.obs)))
        dist = float(np.linalg.norm(pos - ref.Ow))
        self.pool.normal[mp.pid] = normal / max(len(mp.obs), 1)
        self.pool.max_dist[mp.pid] = dist
        self.pool.min_dist[mp.pid] = dist

    # -- keyframes ----------------------------------------------------------

    def add_keyframe(self, frame: FrameData) -> KeyFrame:
        # place-recognition hook (System wires it when loop closing computes
        # global descriptors, models/netvlad.py)
        if self.global_desc_fn is not None:
            gd = self.global_desc_fn(frame)
            if gd is not None:
                frame.global_desc = gd
        kf = KeyFrame(self.next_kf_id, frame)
        self.next_kf_id += 1
        self.keyframes[kf.kf_id] = kf
        if self.kf_origin < 0:
            self.kf_origin = kf.kf_id
        return kf

    def update_connections(self, kf: KeyFrame) -> None:
        """keyframe.cpp:757-860."""
        counter: Dict[int, int] = {}
        for pid in kf.mp_ids:
            if pid < 0:
                continue
            mp = self.get_point(int(pid))
            if mp is None or mp.bad:
                continue
            for other_id in mp.obs:
                if other_id != kf.kf_id:
                    counter[other_id] = counter.get(other_id, 0) + 1
        if not counter:
            return
        kf_max = max(counter, key=counter.get)
        pairs = [(w, kid) for kid, w in counter.items() if w >= COVIS_TH]
        if not pairs:
            pairs = [(counter[kf_max], kf_max)]
        kf.connections = {kid: w for w, kid in pairs}
        for w, kid in pairs:
            other = self.keyframes.get(kid)
            if other is not None:
                other.connections[kf.kf_id] = w
                other.ordered_neighbors = sorted(
                    other.connections, key=lambda k: (-other.connections[k], k))
        kf.ordered_neighbors = sorted(
            kf.connections, key=lambda k: (-kf.connections[k], k))
        if kf.first_connection and kf.kf_id != self.kf_origin:
            kf.parent = kf_max
            self.keyframes[kf_max].children.add(kf.kf_id)
            kf.first_connection = False

    def erase_keyframe(self, kf: KeyFrame) -> None:
        """KeyFrame::SetBadFlag (keyframe.cpp): drop observations, detach
        covisibility, re-parent children through best surviving covisibles."""
        if kf.bad or kf.not_erase or kf.kf_id == self.kf_origin:
            return
        for idx, pid in enumerate(kf.mp_ids):
            if pid >= 0:
                mp = self.get_point(int(pid))
                if mp is not None and not mp.bad:
                    self.erase_observation(mp, kf.kf_id)
        for kid in list(kf.connections):
            other = self.keyframes.get(kid)
            if other is not None:
                other.connections.pop(kf.kf_id, None)
                other.ordered_neighbors = sorted(
                    other.connections, key=lambda k: (-other.connections[k], k))
        # spanning-tree re-parenting: greedily attach each child to the
        # candidate parent with the strongest covisibility link
        parent_candidates = {kf.parent} if kf.parent >= 0 else set()
        children = set(kf.children)
        while children:
            best = None  # (weight, child, new_parent)
            for c in children:
                child = self.keyframes.get(c)
                if child is None or child.bad:
                    children.discard(c)
                    best = None
                    break
                for kid, w in child.connections.items():
                    if kid in parent_candidates:
                        if best is None or w > best[0]:
                            best = (w, c, kid)
            if best is None:
                break
            _, c, new_parent = best
            self.keyframes[c].parent = new_parent
            self.keyframes[new_parent].children.add(c)
            parent_candidates.add(c)
            children.discard(c)
        for c in children:  # leftovers attach to the erased KF's parent
            if kf.parent >= 0:
                self.keyframes[c].parent = kf.parent
                self.keyframes[kf.parent].children.add(c)
        if kf.parent >= 0:
            self.keyframes[kf.parent].children.discard(kf.kf_id)
        # Tcp must be readable the moment bad is observable (trajectory
        # re-chaining walks `while kf.bad: kf.Tcp @ ...`), so assign it first
        kf.Tcp = kf.Tcw @ np.linalg.inv(self.keyframes[kf.parent].Tcw) \
            if kf.parent >= 0 else np.eye(4, dtype=np.float32)
        kf.bad = True

    def scene_median_depth(self, kf: "KeyFrame") -> float:
        """KeyFrame::ComputeSceneMedianDepth(2) (keyframe.cpp): median
        camera-frame depth of the KF's bound points (-1 if none)."""
        zs = []
        R2 = kf.Tcw[2, :3]
        t2 = kf.Tcw[2, 3]
        for pid in kf.mp_ids:
            if pid >= 0:
                zs.append(float(R2 @ self.pool.pos[pid] + t2))
        if not zs:
            return -1.0
        zs.sort()
        return zs[(len(zs) - 1) // 2]

    # -- queries ------------------------------------------------------------

    def n_keyframes(self) -> int:
        return sum(1 for k in self.keyframes.values() if not k.bad)

    def n_points(self) -> int:
        # count live MapPoints, not pool.alive: retired slots stay alive
        # until the graveyard flush (GRAVEYARD_EPOCHS) and must not read
        # as map content
        return sum(1 for mp in self.points.values()
                   if not mp.bad and mp.replaced_by < 0)

    def tracked_in_common(self, kf: KeyFrame, current_pids: set):
        """KeyFrame::getTrackedInCommon (keyframe.cpp:697-724): of this KF's
        tracked points, how many are in `current_pids`."""
        n_common = 0
        total = 0
        for pid in kf.mp_ids:
            if pid < 0:
                continue
            mp = self.get_point(int(pid))
            if mp is None or mp.bad:
                continue
            total += 1
            if mp.pid in current_pids:
                n_common += 1
        return n_common, max(total, 1)

    def clear(self) -> None:
        # the System-installed hook survives a reset (else every post-reset
        # keyframe lacks a global descriptor and loop closing goes silently
        # dead), and so does the lock, which a caller may hold
        hook = self.global_desc_fn
        lock = self.update_lock
        self.__init__(self.pool.capacity, self.pool.device)
        self.global_desc_fn = hook
        self.update_lock = lock
