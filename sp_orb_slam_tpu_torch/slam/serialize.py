"""Map serialization: save a built map, reload it, serve localization.

The port of the JAX package's slam/serialize.py, in the same format so that
maps cross between the two packages both ways.  The reference has no map
persistence (its only outputs are trajectory text files); this is the
build-once, localize-many pattern: `System.save_map` after a mapping run,
then any number of later runs `System.load_map` and run localization
against it (activate_localization_mode + relocalization as the cold start).

Format (FORMAT_VERSION 1): ONE `np.savez_compressed` archive, arrays only
(no pickle, so a load is safe on untrusted files).  Map points are
compacted to live rows with a pid remap on load; each keyframe's feature
arrays (the host mirrors + descriptors + dust map) are stored per keyframe,
and the device residents are rebuilt as torch tensors on the loading
system's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sp_orb_slam_tpu_torch.slam.frame import FrameData
from sp_orb_slam_tpu_torch.slam.map import KeyFrame, Map, MapPoint

FORMAT_VERSION = 1


def save_map(world: Map, path: str) -> None:
    """Write the live map (non-bad keyframes + non-bad points) to `path`."""
    arrays: Dict[str, np.ndarray] = {
        "version": np.int64(FORMAT_VERSION),
        "next_kf_id": np.int64(world.next_kf_id),
        "kf_origin": np.int64(world.kf_origin),
    }

    pids = sorted(mp.pid for mp in world.points.values()
                  if not mp.bad and mp.replaced_by < 0)
    idx = np.asarray(pids, np.int64)
    pool = world.pool
    arrays["mp_pid"] = idx
    for name in ("pos", "desc", "desc_track", "normal", "min_dist",
                 "max_dist"):
        arrays[f"mp_{name}"] = getattr(pool, name)[idx]
    arrays["mp_scalars"] = np.asarray(
        [(mp.pid, mp.first_kf, mp.ref_kf, mp.n_visible, mp.n_found)
         for mp in (world.points[p] for p in pids)], np.int64
    ).reshape(-1, 5)
    arrays["mp_obs"] = np.asarray(
        [(mp.pid, kf_id, kp_idx)
         for mp in (world.points[p] for p in pids)
         for kf_id, kp_idx in mp.obs.items()], np.int64).reshape(-1, 3)

    kfs = sorted((kf for kf in world.keyframes.values() if not kf.bad),
                 key=lambda k: k.kf_id)
    arrays["kf_ids"] = np.asarray([kf.kf_id for kf in kfs], np.int64)
    arrays["kf_frame_ids"] = np.asarray([kf.frame_id for kf in kfs],
                                        np.int64)
    arrays["kf_timestamps"] = np.asarray([kf.timestamp for kf in kfs],
                                         np.float64)
    arrays["kf_Tcw"] = (np.stack([kf.Tcw for kf in kfs])
                        if kfs else np.zeros((0, 4, 4), np.float32))
    arrays["kf_parent"] = np.asarray([kf.parent for kf in kfs], np.int64)
    arrays["kf_first_connection"] = np.asarray(
        [kf.first_connection for kf in kfs], bool)
    arrays["kf_edges"] = np.asarray(
        [(kf.kf_id, other, w) for kf in kfs
         for other, w in kf.connections.items()], np.int64).reshape(-1, 3)
    arrays["kf_loop_edges"] = np.asarray(
        [(kf.kf_id, other) for kf in kfs for other in kf.loop_edges],
        np.int64).reshape(-1, 2)
    for kf in kfs:
        p = f"kf{kf.kf_id}_"
        d = kf.data
        arrays[p + "uv"] = d.uv
        arrays[p + "score"] = d.score
        arrays[p + "response"] = d.response
        arrays[p + "valid"] = d.valid
        arrays[p + "cov2_inv"] = d.cov2_inv
        arrays[p + "occ_grid"] = d.occ_grid
        arrays[p + "count"] = np.int64(d.count)
        arrays[p + "desc"] = d.desc_host
        arrays[p + "dust"] = d.dust_dev.cpu().numpy()
        arrays[p + "mp_ids"] = kf.mp_ids
        if kf.global_desc is not None:
            arrays[p + "gd"] = np.asarray(kf.global_desc)
    np.savez_compressed(path, **arrays)


def load_map(path: str, mp_capacity: int = 65536,
             device: str | torch.device = "cuda") -> Map:
    """Rebuild a Map from `save_map` output (of either package) with its
    device residents on `device`, the card unless the caller passes "cpu"
    (without a card this raises).  Map points get fresh pool slots (pids
    are remapped; observation and binding tables are rewritten)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "load the map onto the CPU")
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported map format {int(z['version'])}")
    world = Map(mp_capacity, device=dev)
    world.next_kf_id = int(z["next_kf_id"])
    world.kf_origin = int(z["kf_origin"])

    # keyframes (shared members hoisted out of the loop: NpzFile decompresses
    # a whole member on every access)
    kf_frame_ids = z["kf_frame_ids"]
    kf_timestamps = z["kf_timestamps"]
    kf_Tcw = z["kf_Tcw"]
    kf_parent = z["kf_parent"]
    kf_first_connection = z["kf_first_connection"]
    files = set(z.files)
    for i, kf_id in enumerate(z["kf_ids"]):
        kf_id = int(kf_id)
        p = f"kf{kf_id}_"
        desc = z[p + "desc"]
        occ_grid = z[p + "occ_grid"]
        frame = FrameData(
            frame_id=int(kf_frame_ids[i]),
            timestamp=float(kf_timestamps[i]),
            uv=z[p + "uv"], score=z[p + "score"],
            response=z[p + "response"], valid=z[p + "valid"],
            cov2_inv=z[p + "cov2_inv"], occ_grid=occ_grid,
            count=int(z[p + "count"]),
            desc_dev=torch.from_numpy(desc).to(dev),
            dust_dev=torch.from_numpy(z[p + "dust"]).to(dev),
            occ_grid_dev=torch.from_numpy(occ_grid).to(dev),
            global_desc=z[p + "gd"] if (p + "gd") in files else None,
        )
        frame._desc_host = desc
        frame.Tcw = kf_Tcw[i]
        kf = KeyFrame(kf_id, frame)
        kf.Tcw = kf_Tcw[i]
        kf.parent = int(kf_parent[i])
        kf.first_connection = bool(kf_first_connection[i])
        kf.mp_ids = z[p + "mp_ids"].copy()
        world.keyframes[kf_id] = kf
    for kf_id, other, w in z["kf_edges"]:
        kf = world.keyframes.get(int(kf_id))
        if kf is not None:
            kf.connections[int(other)] = int(w)
    for kf in world.keyframes.values():
        kf.ordered_neighbors = sorted(
            kf.connections, key=lambda k: (-kf.connections[k], k))
        if kf.parent >= 0 and kf.parent in world.keyframes:
            world.keyframes[kf.parent].children.add(kf.kf_id)
    for kf_id, other in z["kf_loop_edges"]:
        kf = world.keyframes.get(int(kf_id))
        if kf is not None:
            kf.loop_edges.add(int(other))

    # map points (fresh pool slots; remap old pid -> new pid)
    remap: Dict[int, int] = {}
    scalars = z["mp_scalars"]
    names = ("pos", "desc", "desc_track", "normal", "min_dist", "max_dist")
    mp_arrays = {name: z[f"mp_{name}"] for name in names}
    for row, old_pid in enumerate(z["mp_pid"]):
        old_pid = int(old_pid)
        pid = world.pool.alloc()
        remap[old_pid] = pid
        for name in names:
            getattr(world.pool, name)[pid] = mp_arrays[name][row]
        _, first_kf, ref_kf, n_vis, n_found = scalars[row]
        world.points[pid] = MapPoint(pid=pid, first_kf=int(first_kf),
                                     ref_kf=int(ref_kf), n_visible=int(n_vis),
                                     n_found=int(n_found))
    # the bulk host rewrite above bypassed the dirty tracking: rebuild the
    # device descriptor banks from scratch on next use
    world.pool.invalidate_banks()
    for old_pid, kf_id, kp_idx in z["mp_obs"]:
        mp = world.points.get(remap.get(int(old_pid), -1))
        if mp is not None:
            mp.obs[int(kf_id)] = int(kp_idx)
    # rewrite the KF binding tables through the remap
    for kf in world.keyframes.values():
        ids = kf.mp_ids
        for j in range(len(ids)):
            if ids[j] >= 0:
                ids[j] = remap.get(int(ids[j]), -1)
        kf.data.mp_ids = ids.copy()
    return world
