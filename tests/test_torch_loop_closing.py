"""The port's loop closing (slam/loop_closing.py) against the JAX package's.

- `search_by_sim3`: index-equal to the JAX matcher on seeded inputs.
- The drifted loop map of tests/test_loop_closing.py, built in each package
  from its own `SyntheticDataset(loop=True)` with the same seed: both
  loopers take JAX's Sim3 RANSAC draws (the port's `_sim3_draws` is handed
  the JAX stream), detect the same candidates, close on the same matched
  keyframe, agree on Scw (R and t within 1e-3, s within 1e-3 relative) and
  on every keyframe centre after the essential graph (1e-3: 20 pose-graph
  float32 LM iterations whose rounding differs between LAPACK builds),
  and both bring the loop ends closer to ground truth.  After global BA
  the centres agree within a tolerance derived from the JAX package's own
  drift under one-ulp moves of its input (ROADMAP queue 3, D1).
- The project/match/fuse gates, loop closing after a System reset, and
  the rendered room's loop on the port alone at 376x240 (220 frames: at
  least one loop, 0 LOST, ATE < 0.2, tests/test_rendered_loop.py's gate).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.ops import matching as jmatching
from sp_orb_slam_tpu.slam import local_mapping as jlm
from sp_orb_slam_tpu.slam.kernels import TrackingKernels as JKernels
from sp_orb_slam_tpu.slam.local_mapping import LocalMapping as JMapper
from sp_orb_slam_tpu.slam.loop_closing import LoopClosing as JLoop
from sp_orb_slam_tpu.slam.map import Map as JMap
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io import dataset as tds
from sp_orb_slam_tpu_torch.ops import matching as tmatching
from sp_orb_slam_tpu_torch.slam.frame import FrameData
from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels
from sp_orb_slam_tpu_torch.slam.local_mapping import (LocalMapping,
                                                      assemble_global_ba)
from sp_orb_slam_tpu_torch.slam.loop_closing import LoopClosing
from sp_orb_slam_tpu_torch.slam.map import Map
from tests.test_loop_closing import build_drifted_loop_map as jbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "sp_rendered.npz")
VLAD_WEIGHTS = os.path.join(REPO, "weights", "vlad_rendered.npz")

LOOP_CFG = {
    "dataset": "synthetic", "use_loop": True,
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "fps": 20.0},
    "tracking": {"num_features": 250},
    "loop": {"use_loop": True},
    "runtime": {"max_keypoints": 256, "dust_points_cap": 128,
                "local_points_cap": 1024, "ba_kfs_cap": 32,
                "ba_points_cap": 1024, "ba_obs_cap": 4096,
                "init_ransac_iters": 60},
}


class JaxSim3Draws:
    """The JAX looper's RANSAC draws (loop_closing.py: PRNGKey(271828), one
    split per RANSAC, randint over the pair count)."""

    def __init__(self):
        self.key = jax.random.PRNGKey(271828)

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.randint(
            sub, (300, 3), 0, max(n, 1))))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ search_by_sim3


def test_search_by_sim3_index_equal(rng):
    N, K = 96, 128
    K_intr = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    bounds = np.array([0.0, 319.0, 0.0, 239.0], np.float32)

    def side():
        pos = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                        rng.uniform(3, 7, N)], -1).astype(np.float32)
        ok = rng.random(N) > 0.2
        desc = rng.normal(size=(N, 256)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        dist = np.linalg.norm(pos, axis=-1)
        # the gate reads the distance in the other camera (scale 1.2 or
        # 1 / 1.2 away): most bands hold it, some do not
        dmin = (dist * rng.uniform(0.4, 1.0, N)).astype(np.float32)
        dmax = (dist * rng.uniform(1.0, 1.8, N)).astype(np.float32)
        return pos, ok, desc, dmin, dmax

    def image(pos, desc, sR, t):
        pc = pos @ sR.T + t
        uv = np.stack([K_intr[0] * pc[:, 0] / pc[:, 2] + K_intr[2],
                       K_intr[1] * pc[:, 1] / pc[:, 2] + K_intr[3]], -1)
        kuv = np.concatenate([uv[:K // 2], rng.uniform(0, 300, (K // 2, 2))])
        kuv = (kuv + rng.normal(0, 2.0, kuv.shape)).astype(np.float32)
        kd = np.concatenate([desc[:K // 2] + rng.normal(
            0, 0.05, (K // 2, 256)), rng.normal(size=(K // 2, 256))])
        kd = (kd / np.linalg.norm(kd, axis=-1, keepdims=True)).astype(
            np.float32)
        return kuv, kd, rng.random(K) > 0.1

    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    s, t = 1.2, np.array([0.1, -0.05, 0.2])
    sR21, t21 = (s * R).astype(np.float32), t.astype(np.float32)
    sR12 = (R.T / s).astype(np.float32)
    t12 = (-(R.T @ t) / s).astype(np.float32)
    mp1 = side()
    mp2 = side()
    kp2 = image(mp1[0], mp1[2], sR21, t21)
    kp1 = image(mp2[0], mp2[2], sR12, t12)
    args = (*mp1, *kp1, *mp2, *kp2, sR21, t21, sR12, t12, K_intr, bounds)
    j1, j2 = jmatching.search_by_sim3(*map(jnp.asarray, args), radius=7.5)
    t1, t2 = tmatching.search_by_sim3(*map(_t, args), radius=7.5)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    assert (t1.numpy() >= 0).sum() > 10 and (t2.numpy() >= 0).sum() > 10


# ------------------------------------------------------ the drifted loop map


def build_drifted_loop_map(cfg, world, n_frames=34, n_revisit=6):
    """The port's copy of tests/test_loop_closing.py's map: a drifted
    keyframe circle (each point placed in its first observer's warped
    frame) on the port's synthetic loop rail.  Returns (ds, kfs)."""
    from tests.test_loop_closing import _drift_sim3

    ds = tds.SyntheticDataset(cfg, n_frames=n_frames, n_points=9000, seed=2,
                              pixel_noise=0.1, loop=True)
    base = tds._loop_trajectory(n_frames - n_revisit)
    ds.poses = np.concatenate([base, base[:n_revisit]])
    first_seen, revisit_seen = {}, {}
    kfs = []
    for i in range(n_frames):
        raw = ds.frame(i)
        inj = raw.injected
        R_s, t_s, s_s = _drift_sim3(i, n_frames)
        gtT = np.linalg.inv(ds.poses[i]).astype(np.float64)
        Rd = gtT[:3, :3] @ R_s.T
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = Rd
        Tcw[:3, 3] = s_s * gtT[:3, 3] - Rd @ t_s
        f = FrameData(
            frame_id=i, timestamp=raw.timestamp,
            uv=inj["uv"], score=inj["score"], response=inj["score"],
            valid=inj["valid"], cov2_inv=inj["cov2_inv"],
            occ_grid=inj["occ_grid"], count=inj["count"],
            desc_dev=torch.from_numpy(inj["desc"]),
            dust_dev=torch.from_numpy(inj["dust"]),
            occ_grid_dev=torch.from_numpy(inj["occ_grid"]),
            global_desc=raw.global_desc)
        f._desc_host = inj["desc"]
        f.set_pose(Tcw)
        kf = world.add_keyframe(f)
        kfs.append(kf)
        for k in np.nonzero(inj["valid"])[0]:
            sid = int(inj["point_ids"][k])
            if sid < 0:
                continue
            book = revisit_seen if i >= n_frames - n_revisit else first_seen
            mp = book.get(sid)
            if mp is None:
                P = ds.points[sid].astype(np.float64)
                Pw = s_s * (R_s @ P) + t_s
                mp = world.create_point(Pw.astype(np.float32), kf.kf_id)
                book[sid] = mp
            if kf.kf_id not in mp.obs and kf.mp_ids[int(k)] < 0:
                world.add_observation(mp, kf.kf_id, int(k))
        world.update_connections(kf)
    for mp in world.points.values():
        if mp.bad or not mp.obs:
            continue
        world.compute_distinctive_descriptor(mp)
        last_kf = max(mp.obs)
        world.update_desc_track(mp, last_kf, mp.obs[last_kf])
        world.update_normal_and_depth(mp)
    return ds, kfs


def _record(looper, assemble):
    """Wrap a looper's detection and correction to record what they saw:
    candidates per keyframe, (matched KF, Scw) per loop, every KF centre
    after the essential graph (before global BA) and the global BA problem
    (`assemble`, the package's assemble_global_ba)."""
    rec = {"cands": [], "loops": [], "after_eg": [], "gba_points": [],
           "gba_problem": []}
    detect, correct, launch = (looper._detect, looper._correct_loop,
                               looper._launch_gba)

    def _detect(kf):
        out = detect(kf)
        rec["cands"].append((kf.kf_id, list(out)))
        return out

    def _correct_loop(kf, matched, Scw, hit):
        rec["loops"].append((kf.kf_id, matched, Scw, len(hit[0])))
        return correct(kf, matched, Scw, hit)

    def _launch_gba(kf_id):
        world = looper.map
        rec["after_eg"].append(_centres(world))
        rec["gba_points"].append(
            {p: world.pool.pos[p].astype(np.float64)
             for p, mp in world.points.items() if not mp.bad})
        rec["gba_problem"].append(assemble(world))
        return launch(kf_id)

    looper._detect = _detect
    looper._correct_loop = _correct_loop
    looper._launch_gba = _launch_gba
    return rec


def _centres(world):
    return {k: kf.Ow.astype(np.float64) for k, kf in world.keyframes.items()
            if not kf.bad}


def _loop_gap(ds, kfs):
    """Discrepancy of the loop-end relative pose vs ground truth
    (tests/test_loop_closing.py)."""
    a, b = kfs[0], kfs[-1]
    rel_est = a.Tcw.astype(np.float64) @ np.linalg.inv(
        b.Tcw.astype(np.float64))
    gt_a = np.linalg.inv(ds.poses[a.frame_id]).astype(np.float64)
    gt_b = np.linalg.inv(ds.poses[b.frame_id]).astype(np.float64)
    rel_gt = gt_a @ np.linalg.inv(gt_b)
    dt = np.linalg.norm(rel_est[:3, 3] - rel_gt[:3, 3])
    dR = rel_est[:3, :3] @ rel_gt[:3, :3].T
    return dt + np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))


@pytest.fixture(scope="module")
def drifted_runs():
    """The drifted loop map through both loopers, each recorded."""
    return run_drifted_loops()


def run_drifted_loops():
    """The drifted loop map through both loopers, each recorded."""
    jcfg, cfg = jmerge(JConfig(), LOOP_CFG), _merge_dataclass(Config(),
                                                               LOOP_CFG)
    out = {}
    jworld = JMap()
    jk = JKernels(jcfg)
    jlooper = JLoop(jcfg, jworld, jk, JMapper(jcfg, jworld, jk))
    jds, jkfs = jbuild(jcfg, jworld)
    jgap = _loop_gap(jds, jkfs)
    jrec = _record(jlooper, jlm.assemble_global_ba)
    for kf in jkfs:
        jlooper.insert_keyframe(kf.kf_id)
        jlooper.spin_once()
    out["jax"] = (jlooper, jrec, jgap, _loop_gap(jds, jkfs), jworld)

    world = Map()
    tk = TrackingKernels(cfg, device="cpu")
    looper = LoopClosing(cfg, world, tk, LocalMapping(cfg, world, tk))
    looper._sim3_draws = JaxSim3Draws()
    ds, kfs = build_drifted_loop_map(cfg, world)
    gap = _loop_gap(ds, kfs)
    rec = _record(looper, assemble_global_ba)
    for kf in kfs:
        looper.insert_keyframe(kf.kf_id)
        looper.spin_once()
    out["port"] = (looper, rec, gap, _loop_gap(ds, kfs), world)
    return out


def test_drifted_loop_same_detection(drifted_runs):
    jl, jrec, _, _, _ = drifted_runs["jax"]
    tl, trec, _, _, _ = drifted_runs["port"]
    assert trec["cands"] == jrec["cands"]
    assert tl.n_loops_closed == jl.n_loops_closed >= 1
    assert [r[:2] for r in trec["loops"]] == [r[:2] for r in jrec["loops"]]
    assert [r[3] for r in trec["loops"]] == [r[3] for r in jrec["loops"]]
    assert tl.loops == [r[:2] for r in trec["loops"]]


def test_drifted_loop_same_sim3(drifted_runs):
    jrec, trec = drifted_runs["jax"][1], drifted_runs["port"][1]
    for (_, _, jS, _), (_, _, tS, _) in zip(jrec["loops"], trec["loops"]):
        np.testing.assert_allclose(tS[0], jS[0], atol=1e-3)
        np.testing.assert_allclose(tS[1], jS[1], atol=1e-3)
        assert abs(tS[2] / jS[2] - 1.0) < 1e-3, (tS[2], jS[2])


def test_drifted_loop_same_correction(drifted_runs):
    """Every KF centre and map point after the essential graph (global BA's
    input), the loop-end gap after global BA, and the gap collapsing in
    both packages.  The KF centres after global BA are held by
    test_gba_centres_within_the_references_own_drift: given the same
    packed problem, the two bundle_adjusts agree to 3e-6 after 3 LM
    iterations but drift apart along the map's weakly constrained
    directions by the 10th (ROADMAP queue 3, D1)."""
    jl, jrec, jgap0, jgap1, jworld = drifted_runs["jax"]
    tl, trec, gap0, gap1, world = drifted_runs["port"]
    assert len(trec["after_eg"]) == len(jrec["after_eg"]) >= 1
    for jc, tc in zip(jrec["after_eg"] + jrec["gba_points"],
                      trec["after_eg"] + trec["gba_points"]):
        assert sorted(tc) == sorted(jc)
        err = max(np.abs(tc[k] - jc[k]).max() for k in jc)
        assert err < 1e-3, err
    assert abs(gap0 - jgap0) < 1e-4
    assert abs(gap1 - jgap1) < 1e-3, (gap1, jgap1)
    assert jgap1 < 0.35 * jgap0, (jgap0, jgap1)
    assert gap1 < 0.35 * gap0, (gap0, gap1)
    # revisit duplicates were fused into the original points
    n_replaced = sum(1 for mp in world.points.values()
                     if mp.replaced_by >= 0)
    n_jreplaced = sum(1 for mp in jworld.points.values()
                      if mp.replaced_by >= 0)
    assert n_replaced == n_jreplaced and n_replaced > 20


def test_gba_drift_is_bundle_adjusts(drifted_runs):
    """The loop's global BA problem, re-assembled from the port's map after
    the correction, through both packages' bundle_adjust: they agree to
    1e-4 for the first 3 iterations (the divergence D1 records grows with
    the iteration count, not from the loop closer's input)."""
    from sp_orb_slam_tpu.optim import ba as jba
    from sp_orb_slam_tpu_torch.optim import ba as tba
    from sp_orb_slam_tpu_torch.slam.local_mapping import assemble_global_ba

    world = drifted_runs["port"][4]
    p = assemble_global_ba(world)
    keys = ("poses", "fixed", "points", "pt_valid", "obs_cam", "obs_pt",
            "obs_uv", "obs_w", "obs_valid")
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    j = jba.bundle_adjust(*[jnp.asarray(p[k]) for k in keys],
                          jnp.asarray(K), iters1=3, two_phase=False,
                          robust=True)
    t = tba.bundle_adjust(*[torch.from_numpy(np.array(p[k])) for k in keys],
                          torch.from_numpy(K), iters1=3, two_phase=False,
                          robust=True)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               atol=1e-4)
    v = p["pt_valid"]
    np.testing.assert_allclose(t.points.numpy()[v], np.asarray(j.points)[v],
                               atol=1e-4)


GBA_ITERS = 10     # the loop's global BA (LoopClosing._run_gba)
ULP_SEEDS = 40     # seeded one-ulp moves of the GBA input


def _ulp_moves(poses, seed):
    """`poses` with every entry moved by one float32 ulp, up or down by a
    seeded coin."""
    up = np.random.default_rng(seed).random(poses.shape) < 0.5
    return np.where(up, np.nextafter(poses, np.float32(np.inf)),
                    np.nextafter(poses, np.float32(-np.inf))
                    ).astype(np.float32)


GBA_KEYS = ("poses", "fixed", "points", "pt_valid", "obs_cam", "obs_pt",
            "obs_uv", "obs_w", "obs_valid")


def _gba_centres(problem, poses):
    """KF centres (in the problem's KF order) of BA-solved poses."""
    P = np.asarray(poses, np.float64)[:len(problem["kf_index"])]
    return -np.einsum("nji,nj->ni", P[:, :3, :3], P[:, :3, 3])


def _jax_gba(problem, poses=None, iters=GBA_ITERS):
    """The JAX package's bundle_adjust on a GBA problem, as its looper
    calls it, with `poses` in place of the problem's where given."""
    from sp_orb_slam_tpu.optim import ba as jba

    args = [jnp.asarray(problem[k]) for k in GBA_KEYS]
    if poses is not None:
        args[0] = jnp.asarray(poses)
    K = jnp.asarray(np.array([260.0, 260.0, 160.0, 120.0], np.float32))
    return _gba_centres(problem, jba.bundle_adjust(
        *args, K, iters1=iters, two_phase=False, robust=True).poses)


def _jax_self_drift(problem):
    """How far the JAX package's GBA result moves under each of the
    ULP_SEEDS one-ulp moves of its input poses."""
    base = _jax_gba(problem)
    return [float(np.abs(_jax_gba(problem, _ulp_moves(problem["poses"], s))
                         - base).max()) for s in range(ULP_SEEDS)]


def test_gba_centres_within_the_references_own_drift(drifted_runs):
    """D1 settled: the JAX package's own bundle_adjust, run on its loop's
    global BA problem and again on the same problem with every pose entry
    moved by one float32 ulp (ULP_SEEDS seeded moves), drifts from itself
    after the GBA's 10 iterations by as much as the 0.0275 that separates
    the two packages' KF centres after global BA (up to 0.0305 on this
    map, median 6.2e-4, on the CPU): 10 LM iterations with only the
    origin fixed leave the scale gauge nearly free, lambda shrinks with
    every accepted step, and float32 rounding is amplified along it.  So
    the centres after global BA are compared at twice the JAX package's
    largest self-drift: two runs, each as far from the float64 solution as
    the reference's own rounding takes it, on opposite sides of it."""
    jworld = drifted_runs["jax"][4]
    jrec, trec = drifted_runs["jax"][1], drifted_runs["port"][1]
    assert len(jrec["gba_problem"]) == len(trec["gba_problem"]) == 1
    p = jrec["gba_problem"][0]
    kf_ids = sorted(p["kf_index"], key=p["kf_index"].get)
    base = _jax_gba(p)
    # the JAX looper's own global BA committed these centres to the
    # keyframes its spanning-tree walk reached
    reached = [i for i, k in enumerate(kf_ids)
               if jworld.keyframes[k].Tcw_bef_gba is not None]
    assert reached
    np.testing.assert_allclose(
        base[reached], [jworld.keyframes[kf_ids[i]].Ow for i in reached],
        atol=1e-5)
    tol = 2.0 * max(_jax_self_drift(p))
    jc = _centres(jworld)
    tc = _centres(drifted_runs["port"][4])
    assert sorted(tc) == sorted(jc)
    err = max(np.abs(tc[k] - jc[k]).max() for k in jc)
    assert err < tol, (err, tol)


def gba_drift_probe() -> dict:
    """D1's numbers (ROADMAP queue 3): the two packages' KF centres after
    the loop's global BA, the JAX package's self-drift under one-ulp
    moves, the port's and the JAX package's bundle_adjust on the port's
    GBA problem iteration by iteration, and how far the port's float32
    result lies from its float64 solution with each of its pieces taken
    to float64 in turn.  Run as `JAX_PLATFORMS=cpu python -m
    tests.test_torch_loop_closing d1` (about a minute)."""
    from sp_orb_slam_tpu_torch.optim import ba as tba

    runs = run_drifted_loops()
    jc, tc = _centres(runs["jax"][4]), _centres(runs["port"][4])
    drift = _jax_self_drift(runs["jax"][1]["gba_problem"][0])
    p = runs["port"][1]["gba_problem"][0]
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)

    def port_gba(iters=GBA_ITERS, dtype=torch.float32):
        args = [torch.from_numpy(np.array(p[k])) for k in GBA_KEYS]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        return _gba_centres(p, tba.bundle_adjust(
            *args, torch.from_numpy(K).to(dtype), iters1=iters,
            two_phase=False, robust=True).poses.double().numpy())

    trace = {it: float(np.abs(port_gba(it) - _jax_gba(p, iters=it)).max())
             for it in (3, 7, 8, 9, 10)}
    ref64 = port_gba(dtype=torch.float64)
    pieces = {}

    def to64(fn, wrap):
        def run(*a, **kw):
            return wrap(fn, *a, **kw)
        return run

    def solve64(fn, A, b, **kw):
        x, info = fn(A.double(), b.double())
        return x.to(A.dtype), info

    def inv64(fn, A, **kw):
        x, info = fn(A.double())
        return x.to(A.dtype), info

    def einsum64(fn, eq, *ops):
        if ops[0].dtype != torch.float32:
            return fn(eq, *ops)
        return fn(eq, *[o.double() for o in ops]).float()

    def scatter64(fn, n, idx, vals):
        return fn(n, idx, vals.double()).float()

    for name, (mod, attr, wrap) in {
            "reduced solve": (torch.linalg, "solve_ex", solve64),
            "point inverses": (torch.linalg, "inv_ex", inv64),
            "einsums": (torch, "einsum", einsum64),
            "scatters": (tba, "_scatter", scatter64)}.items():
        real = getattr(mod, attr)
        setattr(mod, attr, to64(real, wrap))
        try:
            pieces[name] = float(np.abs(port_gba() - ref64).max())
        finally:
            setattr(mod, attr, real)
    return {"port_vs_jax_after_gba": max(float(np.abs(tc[k] - jc[k]).max())
                                         for k in jc),
            "jax_self_drift_max": max(drift),
            "jax_self_drift_median": float(np.median(drift)),
            "port_vs_jax_by_iteration": trace,
            "port_f32_vs_f64": float(np.abs(port_gba() - ref64).max()),
            "port_vs_f64_with_one_piece_in_f64": pieces}


# ------------------------------------------------------------------ gates


def test_project_match_fuse_gates():
    """The Fuse-Sim3 geometric gates (sp_matcher.cpp:1159-1171): an
    off-depth or off-normal duplicate is not fused even with a perfect
    descriptor, while the in-range point matches."""
    cfg = _merge_dataclass(Config(), LOOP_CFG)
    world = Map()
    tk = TrackingKernels(cfg, device="cpu")
    looper = LoopClosing(cfg, world, tk, LocalMapping(cfg, world, tk))
    cam = cfg.camera
    N = cfg.runtime.max_keypoints
    rng = np.random.default_rng(3)
    desc = rng.normal(size=(N, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    uv = np.zeros((N, 2), np.float32)
    valid = np.zeros(N, bool)
    uv[0] = [cam.cx, cam.cy]  # keypoint 0 = projection of (0, 0, 5)
    valid[0] = True
    hc, wc = cfg.grid_h, cfg.grid_w
    f = FrameData(
        frame_id=0, timestamp=0.0, uv=uv,
        score=np.zeros(N, np.float32), response=np.zeros(N, np.float32),
        valid=valid, cov2_inv=np.ones((N, 2), np.float32),
        occ_grid=np.full((hc, wc), -1, np.int32), count=1,
        desc_dev=torch.from_numpy(desc),
        dust_dev=torch.zeros(hc, wc),
        occ_grid_dev=torch.full((hc, wc), -1, dtype=torch.int32))
    f._desc_host = desc
    f.set_pose(np.eye(4, dtype=np.float32))
    kf = world.add_keyframe(f)

    def mk_point(dmin, dmax, normal):
        mp = world.create_point(np.array([0.0, 0.0, 5.0], np.float32),
                                kf.kf_id)
        world.pool.write_desc(mp.pid, desc[0])
        world.pool.min_dist[mp.pid] = dmin
        world.pool.max_dist[mp.pid] = dmax
        world.pool.normal[mp.pid] = np.asarray(normal, np.float32)
        return mp

    Scw = (np.eye(3), np.zeros(3), 1.0)  # the KF pose (camera at origin)
    good = mk_point(4.0, 6.0, [0, 0, 1.0])
    assert looper._project_match(kf, Scw, [good.pid], radius=4.0) == \
        {0: good.pid}
    off = mk_point(0.8, 1.0, [0, 0, 1.0])  # dist 5 > 1.2 * dmax
    assert looper._project_match(kf, Scw, [off.pid], radius=4.0) == {}
    back = mk_point(4.0, 6.0, [0, 0, -1.0])  # mean ray points away
    assert looper._project_match(kf, Scw, [back.pid], radius=4.0) == {}
    # out of the window: the keypoint moved 5 px away
    f.uv[0] = [cam.cx + 5.0, cam.cy]
    assert looper._project_match(kf, Scw, [good.pid], radius=4.0) == {}


def test_loop_closes_after_system_reset():
    """tests/test_reset_loop.py on the port: the place-recognition hook
    survives System.reset, and a drifted loop fed to the post-reset looper
    still closes."""
    from sp_orb_slam_tpu_torch.slam.system import System

    s = System(_merge_dataclass(Config(), LOOP_CFG), device="cpu")
    hook = s.map.global_desc_fn
    s.looper.db.append(7)
    s.reset()
    assert s.map.global_desc_fn is hook is not None
    assert s.looper.db == [] and s.mapper.looper is s.looper
    ds, kfs = build_drifted_loop_map(s.cfg, s.map)
    for kf in kfs:
        s.looper.insert_keyframe(kf.kf_id)
        s.looper.spin_once()
    assert s.looper.n_loops_closed >= 1
    assert s.report()["n_loops_closed"] == s.looper.n_loops_closed


@pytest.mark.skipif(not os.path.exists(WEIGHTS),
                    reason="trained checkpoint not present")
def test_rendered_loop_closes():
    """The rendered room's loop through the port's whole image path
    (trained SuperPoint, NetVLAD computed from the extractor's output,
    Sim3 + essential graph + GBA) at tests/test_rendered_loop.py's 376x240
    operating point and gates."""
    from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint
    from sp_orb_slam_tpu_torch.slam.system import System

    cfg = _merge_dataclass(Config(), {
        "use_loop": True,
        "loop": {"use_loop": True,
                 "netvlad_weights": (VLAD_WEIGHTS
                                     if os.path.exists(VLAD_WEIGHTS)
                                     else "")},
        "camera": {"width": 376, "height": 240, "fx": 178.05, "fy": 209.0,
                   "cx": 181.38, "cy": 125.09},
    })
    ds = RenderedDataset(cfg, n_frames=220, seed=5, noise_seed=0)
    sys_ = System(cfg, params=load_checkpoint(WEIGHTS), device="cpu")
    sys_.spin(ds)
    rep = sys_.report()
    assert rep["n_frames"] >= 180, rep
    assert rep["n_lost"] == 0, rep
    assert rep["n_fail_dust"] <= rep["n_frames"] * 0.1, rep
    assert rep["n_loops_closed"] >= 1, rep
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    res = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    assert float(res.rmse) < 0.2, float(res.rmse)


def full_res_loop(package: str, n_frames: int = 220,
                  online: bool = False) -> dict:
    """The rendered room's loop at Config() defaults (752x480, K=896,
    float32) with the fitted NetVLAD weights, through the JAX package's
    System or the port's on the CPU, offline or (`online`) with mapping
    and loop closing on their own threads (the port warmed up first): the
    loops' keyframe ids, the report, the Sim3 ATE and the spin's wall
    seconds.  Too slow for the test suite (minutes); run it as
    `JAX_PLATFORMS=cpu python -m tests.test_torch_loop_closing
    {jax|port} [n_frames] [--online]` (`d1`: gba_drift_probe)."""
    import time

    over = {"use_loop": True, "online": online,
            "loop": {"use_loop": True, "netvlad_weights": VLAD_WEIGHTS}}
    if package == "jax":
        from sp_orb_slam_tpu.eval.ate import ate_sim3
        from sp_orb_slam_tpu.io.render import RenderedDataset
        from sp_orb_slam_tpu.models.weights import load_checkpoint
        from sp_orb_slam_tpu.slam.system import System

        cfg = jmerge(JConfig(), over)
        sys_ = System(cfg, params=load_checkpoint(WEIGHTS))
    else:
        from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
        from sp_orb_slam_tpu_torch.io.render import RenderedDataset
        from sp_orb_slam_tpu_torch.models.weights import load_checkpoint
        from sp_orb_slam_tpu_torch.slam.system import System

        cfg = _merge_dataclass(Config(), over)
        sys_ = System(cfg, params=load_checkpoint(WEIGHTS), device="cpu")
        if online:
            sys_.warmup()
    ds = RenderedDataset(cfg, n_frames=n_frames, seed=5, noise_seed=0)
    frames = list(ds)  # rendered before the clock starts
    t0 = time.perf_counter()
    sys_.spin(frames)
    wall = time.perf_counter() - t0
    ts, poses = sys_.trajectory()
    tg, pg = ds.gt_trajectory()
    ate = ate_sim3(ts, poses[:, :3, 3], tg, pg[:, :3, 3])
    # loop edges join the closing keyframe (the later one) and its match
    loops = sorted({(max(k.kf_id, e), min(k.kf_id, e))
                    for k in sys_.map.keyframes.values()
                    for e in k.loop_edges})
    return dict(package=package, n_frames=n_frames, online=online,
                loops=loops, n_loops_closed=sys_.looper.n_loops_closed,
                ate_rmse=float(ate.rmse), wall_s=wall, report=sys_.report())


if __name__ == "__main__":
    import json
    import sys

    argv = [a for a in sys.argv[1:] if a != "--online"]
    if argv[0] == "d1":
        print(json.dumps(gba_drift_probe()))
    else:
        print(json.dumps(full_res_loop(argv[0], *map(int, argv[1:]),
                                       online="--online" in sys.argv),
                         default=str))
