"""Port parity of the tracking and mapping stages: every ported body of
slam/kernels.py against its JAX twin on seeded inputs from the synthetic
scene (keypoints, descriptors, dust maps and map points of real frames),
on the CPU; plus `TrackingKernels`' packed transfers.

Index outputs (bindings, matches, masks) must be equal, counts too; poses
within 1e-4 and triangulated points within 1e-4 relative (float32 solves
summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.geometry import se3 as jse3
from sp_orb_slam_tpu.io.dataset import SyntheticDataset
from sp_orb_slam_tpu.slam import kernels as jk
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.slam import kernels as tk

torch.set_num_threads(2)

TOL = 1e-4
OVR = {"dataset": "synthetic",
       "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                  "cx": 160.0, "cy": 120.0, "fps": 20.0},
       "tracking": {"num_features": 250},
       "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                   "local_points_cap": 512, "init_ransac_iters": 60}}
JCFG = jmerge(JConfig(), OVR)
CFG = _merge_dataclass(Config(), OVR)
K_INTR = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
BOUNDS = np.array([0.0, 319.0, 0.0, 239.0], np.float32)
DUST_KW = dict(dust_iters=40, huber_delta=0.9, chi2_inlier=0.9)
LOCAL_KW = dict(view_cos_th=0.5, window_th=4.0, match_adaptive=True,
                c2_thresh=5.0)


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(JCFG, n_frames=12, n_points=3000, seed=6,
                            pixel_noise=0.3)


def _frame(scene, i):
    inj = scene.frame(i).injected
    return dict(uv=inj["uv"], desc=inj["desc"], valid=inj["valid"],
                cov=np.ones_like(inj["uv"]), occ=inj["occ_grid"],
                dust=inj["dust"], ids=inj["point_ids"])


def _tcw(scene, i):
    return np.linalg.inv(scene.poses[i]).astype(np.float32)


def _perturb(T, seed, rot=0.004, trans=0.03):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, rot, 3),
                         rng.normal(0, trans, 3)]).astype(np.float32)
    return (np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ T).astype(np.float32)


def _points(scene, ids, cap, seed):
    """Map points of the scene ids, noisy positions, padded to cap."""
    rng = np.random.default_rng(seed)
    n = min(len(ids), cap)
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 256), np.float32)
    valid = np.zeros(cap, bool)
    pos[:n] = scene.points[ids[:n]] + rng.normal(0, 0.01, (n, 3))
    desc[:n] = scene.descs[ids[:n]]
    valid[:n] = True
    return pos, desc, valid


def _j(x):
    return jnp.asarray(x)


def _t(x):
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


def _compare(got, want, floats=("Tcw",), tol=TOL):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        b = np.asarray(want[k])
        if any(k.endswith(f) for f in floats) or b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _dust_args(scene, i=5):
    f = _frame(scene, i)
    prev = _frame(scene, i - 1)
    ids = prev["ids"][prev["valid"]]
    pos, desc, valid = _points(scene, ids, 128, i)
    T0 = _perturb(_tcw(scene, i), i)
    return (T0, pos, desc, valid, f["dust"], f["occ"], f["desc"], f["uv"],
            f["cov"], f["valid"])


def test_dust_track_body(scene):
    args = _dust_args(scene)
    want = jk.dust_track_body(*map(_j, args), _j(K_INTR), **DUST_KW)
    got = tk.dust_track_body(*map(_t, args), _t(K_INTR), **DUST_KW)
    _compare(got, want, floats=("Tcw", "Tcw_coarse"))
    assert int(got["n_match"]) > 40


def _track_args(scene, i, cap, seed, fan=None):
    f = _frame(scene, i)
    prev = _frame(scene, i - 1)
    ids = prev["ids"][prev["valid"]]
    pos, desc, valid = _points(scene, ids, cap, seed)
    T0 = _perturb(_tcw(scene, i), seed)
    if fan is not None:
        T0 = np.stack([_perturb(_tcw(scene, i), seed + s, 0.02, 0.1)
                       for s in range(fan)])
    return (T0, pos, desc, valid, f["desc"], f["uv"], f["cov"], f["valid"])


def test_motion_track_body(scene):
    args = _track_args(scene, 6, 512, 1)
    kw = dict(radius=15.0, n_retry_th=20)
    want = jk.motion_track_body(*map(_j, args), _j(K_INTR), _j(BOUNDS), **kw)
    got = tk.motion_track_body(*map(_t, args), _t(K_INTR), _t(BOUNDS), **kw)
    _compare(got, want)
    assert int(got["n_inlier"]) > 40


def test_ref_track_body(scene):
    args = _track_args(scene, 7, 256, 2)
    want = jk.ref_track_body(*map(_j, args), _j(K_INTR))
    got = tk.ref_track_body(*map(_t, args), _t(K_INTR))
    _compare(got, want)
    assert int(got["n_inlier"]) > 40


def test_reloc_track_body(scene):
    args = _track_args(scene, 8, 256, 3, fan=4)
    want = jk.reloc_track_body(*map(_j, args), _j(K_INTR), _j(BOUNDS))
    got = tk.reloc_track_body(*map(_t, args), _t(K_INTR), _t(BOUNDS))
    _compare(got, want)


def _local_args(scene, i=6, L=512):
    f = _frame(scene, i)
    ids = np.unique(np.concatenate([_frame(scene, j)["ids"]
                                    for j in (i - 2, i - 1)]))
    ids = ids[ids >= 0]
    pos, desc, valid = _points(scene, ids, L, i)
    normal = pos - np.linalg.inv(_tcw(scene, i - 1))[:3, 3]
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-9)
    normal = np.where(valid[:, None], normal, 0).astype(np.float32)
    # the coarse stage already bound a third of the frame's keypoints
    lut = {p: li for li, p in enumerate(ids[:L])}
    kp2mp0 = np.full(len(f["uv"]), -1, np.int64)
    skip = np.zeros(L, bool)
    for k in np.nonzero(f["valid"])[0][::3]:
        li = lut.get(int(f["ids"][k]))
        if li is not None:
            kp2mp0[k] = li
            skip[li] = True
    return f, pos, desc, normal, valid, skip, kp2mp0


def test_local_map_track_body(scene):
    f, pos, desc, normal, valid, skip, kp2mp0 = _local_args(scene)
    args = (_perturb(_tcw(scene, 6), 9), pos, desc, normal, valid, skip,
            kp2mp0, f["desc"], f["uv"], f["cov"], f["valid"])
    want = jk.local_map_track_body(*map(_j, args), _j(K_INTR), _j(BOUNDS),
                                   **LOCAL_KW)
    got = tk.local_map_track_body(*map(_t, args), _t(K_INTR), _t(BOUNDS),
                                  **LOCAL_KW)
    _compare(got, want)
    assert int(got["n_extra"]) > 20


def test_fused_track_body(scene):
    dargs = _dust_args(scene, 6)
    f, pos, desc, normal, valid, _, _ = _local_args(scene)
    # dust candidates map into the local set where their scene ids agree
    d2l = np.full(128, -1, np.int64)
    d2l[:64] = np.arange(64)
    args = (*dargs[:6], pos, desc, normal, valid, d2l, *dargs[6:])
    want = jk.fused_track_body(*map(_j, args), _j(K_INTR), _j(BOUNDS),
                               **DUST_KW, **LOCAL_KW)
    got = tk.fused_track_body(*map(_t, args), _t(K_INTR), _t(BOUNDS),
                              **DUST_KW, **LOCAL_KW)
    _compare(got, want, floats=("Tcw", "Tcw_coarse"))


def test_init_body(scene):
    f1, f2 = _frame(scene, 0), _frame(scene, 4)
    args = (f1["desc"], f1["uv"], f1["valid"], f1["uv"], f2["desc"],
            f2["uv"], f2["valid"])
    key = jax.random.PRNGKey(5)
    want = jk.init_body(*map(_j, args), _j(K_INTR), key, window=100,
                        ratio=0.9, ransac_iters=60)

    def draws(n):  # the JAX package's draws for this match count
        return np.array(jax.random.randint(key, (60, 8), 0, max(n, 1)))

    got = tk.init_body(*map(_t, args), _t(K_INTR), draws, window=100,
                       ratio=0.9)
    assert bool(want["ok"])
    tri = np.asarray(want["triangulated"])
    np.testing.assert_allclose(got["points"].numpy()[tri],
                               np.asarray(want["points"])[tri], atol=TOL,
                               rtol=TOL)
    got["points"] = want["points"]
    _compare(got, want, floats=("R21", "t21"))


def test_triangulate_and_fuse_bodies(scene):
    f1, f2 = _frame(scene, 6), _frame(scene, 3)
    T1, T2 = _tcw(scene, 6), _tcw(scene, 3)
    rng = np.random.default_rng(0)
    free1 = f1["valid"] & (rng.random(256) > 0.3)
    free2 = f2["valid"] & (rng.random(256) > 0.3)
    args = (T1, T2, f1["uv"], f1["desc"], f1["cov"], free1, f2["uv"],
            f2["desc"], f2["cov"], free2)
    want = jk.triangulate_body(*map(_j, args), _j(K_INTR), nn_ratio=0.7)
    got = tk.triangulate_body(*map(_t, args), _t(K_INTR), nn_ratio=0.7)
    good = np.asarray(want["good"])
    assert good.sum() > 30
    for k in ("points", "z1", "z2"):
        np.testing.assert_allclose(got[k].numpy()[good],
                                   np.asarray(want[k])[good], rtol=TOL,
                                   atol=TOL, err_msg=k)
    for k in ("tau1", "tau2"):  # a difference of two depths: see geometry
        np.testing.assert_allclose(got[k].numpy()[good],
                                   np.asarray(want[k])[good], rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    for k in ("match21", "good", "n_good"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    _, pos, desc, normal, valid, _, _ = _local_args(scene, 6)
    dist = np.linalg.norm(pos - np.linalg.inv(T1)[:3, 3], axis=1)
    fargs = (T1, pos, desc, normal, (0.9 * dist).astype(np.float32),
             (1.1 * dist).astype(np.float32), valid, f1["uv"], f1["desc"],
             f1["valid"])
    want = jk.fuse_body(*map(_j, fargs), _j(K_INTR), _j(BOUNDS), radius=3.0)
    got = tk.fuse_body(*map(_t, fargs), _t(K_INTR), _t(BOUNDS), radius=3.0)
    _compare(got, want)
    assert (got["best_idx"] >= 0).sum() > 30


def test_tracking_kernels_packed_transfers(scene):
    """TrackingKernels runs a stage from numpy arguments (one packed
    upload) and returns the JAX package's unpacked fields (one packed
    readback); it refuses the card without one."""
    kern = tk.TrackingKernels(CFG, device="cpu")
    args = _dust_args(scene)
    got = kern.dust_track(*args)
    want = jk.TrackingKernels(JCFG).dust_track(*args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
    bank = torch.from_numpy(np.array(args[2]))
    rows = np.array([3, 0, 5, 1], np.int32)
    valid = np.array([True, True, False, True])
    g = kern.gather_rows(bank, rows, valid)
    assert torch.equal(g[2], torch.zeros(256))
    assert torch.equal(g[0], bank[3])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tk.TrackingKernels(CFG)
