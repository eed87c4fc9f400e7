"""The port's multi-stream serving path (slam/fleet.py) on the CPU.

(a) every batched stage (dust, motion, reloc, local narrow and wide; plain
    and bank mode) and the mapper's batches equal their per-row stages on
    3 rows of the synthetic scene: index outputs exactly, poses within
    1e-4 (float32 sums in another order under vmap);
(b) the port's 2-stream fleet on the injected synthetic rail (2 x 24
    frames) equals the port's single-stream `System.run` on each stream:
    the same pose count, poses within 5e-4 (tests/test_fleet.py:122-161);
(c) each fleet stream against the JAX package's single-stream System on
    the same stream, the port taking the JAX init draws: ATE within 0.02,
    the same LOST frames, keyframe and point counts within 15 %
    (tests/test_torch_system.py's tolerances);
(d) batched extraction at B=2 equals B=1 (uv atol 1e-5, desc atol 1e-4);
(e) R1: the fleet path scrubs a replaced point from the last frame's
    bindings, as the JAX package's single-stream path does;
(f) R2: `_bankify` rejects rows that disagree on bank mode and keeps one
    stacked bank per row composition.
"""

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.slam.kernels import TrackingKernels as JKernels
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.eval.ate import ate_sim3
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.slam import kernels as tk
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
from sp_orb_slam_tpu_torch.slam.system import System
from test_torch_slam_kernels import (_dust_args, _frame, _local_args,
                                     _perturb, _tcw, _track_args)
from test_torch_system import SMALL, JaxInitDraws

torch.set_num_threads(2)

TOL = 1e-4
N_FRAMES = 24
SEEDS = (1, 2)


def _cfg():
    return _merge_dataclass(Config(), SMALL)


@pytest.fixture(scope="module")
def scene():
    cfg = jmerge(JConfig(), {**SMALL, "runtime": {
        **SMALL["runtime"], "local_points_cap": 512}})
    return JSynthetic(cfg, n_frames=12, n_points=3000, seed=6,
                      pixel_noise=0.3)


@pytest.fixture(scope="module")
def kern():
    cfg = _merge_dataclass(Config(), {**SMALL, "runtime": {
        **SMALL["runtime"], "local_points_cap": 512}})
    return tk.TrackingKernels(cfg, device="cpu")


# ------------------------------------------------------ (a) batched stages


def _local_row(scene, i):
    f, pos, desc, normal, valid, skip, kp2mp0 = _local_args(scene, i)
    return (_perturb(_tcw(scene, i), 9 + i), pos, desc, normal, valid, skip,
            kp2mp0, f["desc"], f["uv"], f["cov"], f["valid"])


# stage -> (row builder, per-row method, batched call, point-descriptor
#           slot, frame-descriptor slot)
STAGES = {
    "dust": (lambda s, i: _dust_args(s, i), "dust_track",
             lambda k, rows, bank: k.dust_track_batch(rows, bank=bank),
             2, 6),
    "motion": (lambda s, i: _track_args(s, i, 512, i), "motion_track",
               lambda k, rows, bank: k.motion_track_batch(rows, bank=bank),
               2, 4),
    "reloc": (lambda s, i: _track_args(s, i, 256, i, fan=4), "reloc_track",
              lambda k, rows, bank: k.reloc_track_batch(rows, bank=bank),
              2, 4),
    "local": (_local_row, "local_map_track",
              lambda k, rows, bank: k.local_map_track_batch(rows, bank=bank),
              2, 7),
    "local_wide": (_local_row, "local_map_track_wide",
                   lambda k, rows, bank: k.local_map_track_batch(
                       rows, wide=True, bank=bank), 2, 7),
}


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


@pytest.mark.parametrize("bank", [False, True], ids=["plain", "bank"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_batched_stage_matches_per_row(scene, kern, stage, bank):
    build, single, batch, d_idx, f_idx = STAGES[stage]
    rows = [build(scene, i) for i in (5, 6, 7)]
    want = [getattr(kern, single)(*r) for r in rows]
    # the fleet's layout: point descriptors as device tensors (or BankRows
    # rows into a per-stream bank), the frame descriptors ONE PreStacked
    frame_desc = tk.PreStacked(torch.stack([torch.from_numpy(r[f_idx])
                                            for r in rows]))
    rng = np.random.default_rng(0)
    brows, banks = [], []
    for r in rows:
        r = list(r)
        r[f_idx] = frame_desc
        desc = torch.from_numpy(r[d_idx])
        if bank:
            bank_i = torch.from_numpy(
                rng.normal(size=(2 * len(desc), 256)).astype(np.float32))
            slots = rng.permutation(len(bank_i))[:len(desc)]
            bank_i[slots] = desc
            banks.append(bank_i)
            r[d_idx] = slots.astype(np.int32)
        else:
            r[d_idx] = desc
        brows.append(r)
    if bank:
        stacked = tk.PreStacked(torch.stack(banks))
        brows = [tuple(r) + (stacked,) for r in brows]
    got = batch(kern, [tuple(r) for r in brows], bank)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{stage} row {i}")


def test_mapper_batches_match_per_row(scene, kern):
    """The mapper's vmapped triangulation and fuse chunks equal one row at
    a time (points and depths where the gates pass)."""
    rng = np.random.default_rng(0)
    tri, fuse = [], []
    for i, j in ((6, 3), (7, 3), (8, 4)):
        f1, f2 = _frame(scene, i), _frame(scene, j)
        tri.append((_tcw(scene, i), _tcw(scene, j), f1["uv"],
                    torch.from_numpy(f1["desc"]), f1["cov"],
                    f1["valid"] & (rng.random(256) > 0.3), f2["uv"],
                    torch.from_numpy(f2["desc"]), f2["cov"],
                    f2["valid"] & (rng.random(256) > 0.3)))
        _, pos, desc, normal, valid, _, _ = _local_args(scene, i)
        dist = np.linalg.norm(pos - np.linalg.inv(_tcw(scene, i))[:3, 3],
                              axis=1)
        fuse.append((_tcw(scene, i), pos, torch.from_numpy(desc), normal,
                     (0.9 * dist).astype(np.float32),
                     (1.1 * dist).astype(np.float32), valid, f1["uv"],
                     torch.from_numpy(f1["desc"]), f1["valid"]))
    got = kern.triangulate_pair_batch(tri)
    for r, g in zip(tri, got):
        w = kern.triangulate_pair_batch([r])[0]
        for k in ("match21", "good", "n_good"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        good = w["good"]
        assert good.sum() > 30
        for k in ("points", "z1", "z2"):
            np.testing.assert_allclose(g[k][good], w[k][good], atol=TOL,
                                       rtol=TOL, err_msg=k)
    for r, g in zip(fuse, kern.fuse_batch(fuse)):
        _assert_same(g, kern.fuse(*r), "fuse")


# ------------------------------------------------------- (b), (c): the rail


def _jax_draws(tracker, cfg):
    tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)


@pytest.fixture(scope="module")
def rail():
    """The 2-stream fleet over the synthetic rail, each stream's tracker
    taking the JAX package's init draws; the streams and per-stream poses."""
    cfg = _cfg()
    streams = [list(SyntheticDataset(cfg, n_frames=N_FRAMES, seed=s))
               for s in SEEDS]
    fleet = StreamFleet(cfg, len(SEEDS), params=None, device="cpu")
    fleet.warmup()
    for s in fleet.systems:
        _jax_draws(s.tracker, cfg)
    poses = [[] for _ in SEEDS]
    for k in range(N_FRAMES):
        for i, p in enumerate(fleet.tick([st[k] for st in streams])):
            if p is not None:
                poses[i].append(p)
    fleet.shutdown()
    return cfg, fleet, streams, poses


def test_fleet_matches_single_stream(rail):
    cfg, fleet, streams, poses = rail
    assert fleet.systems[0].kernels is fleet.systems[1].kernels
    assert fleet.n_batched_dust > len(SEEDS) * (N_FRAMES // 2)
    assert fleet.n_batched_local > len(SEEDS) * (N_FRAMES // 2)
    for i, stream in enumerate(streams):
        solo = System(cfg, kernels=fleet.kernels, device="cpu")
        _jax_draws(solo.tracker, cfg)
        solo_poses = [p for p in map(solo.run, stream) if p is not None]
        assert solo.tracker.state == ttr.OK
        assert fleet.systems[i].tracker.state == ttr.OK
        assert len(solo_poses) == len(poses[i]), (i, len(solo_poses),
                                                  len(poses[i]))
        for a, b in zip(solo_poses, poses[i]):
            np.testing.assert_allclose(a, b, atol=5e-4)


def test_fleet_streams_match_jax_systems(rail):
    cfg, fleet, streams, _ = rail
    jcfg = jmerge(JConfig(), SMALL)
    jkern = JKernels(jcfg)
    for i, seed in enumerate(SEEDS):
        jsys = JSystem(jcfg, kernels=jkern)
        jsys.spin(JSynthetic(jcfg, n_frames=N_FRAMES, seed=seed))
        tsys = fleet.systems[i]
        jrep, trep = jsys.report(), tsys.report()
        ds = SyntheticDataset(cfg, n_frames=N_FRAMES, seed=seed)
        tg, pg = ds.gt_trajectory()
        ates = []
        for s in (jsys, tsys):
            ts, p = s.trajectory()
            ates.append(ate_sim3(ts, p[:, :3, 3], tg, pg[:, :3, 3]).rmse)
        assert ates[1] < 0.1 and abs(ates[1] - ates[0]) < 0.02, (i, ates)
        j_lost = [t for t, f in zip(jsys.tracker.times,
                                    jsys.tracker.lost_flags) if f]
        t_lost = [t for t, f in zip(tsys.tracker.times,
                                    tsys.tracker.lost_flags) if f]
        assert t_lost == j_lost, (i, t_lost, j_lost)
        for k in ("n_keyframes", "n_points"):
            assert abs(trep[k] - jrep[k]) <= 0.15 * jrep[k], (i, k, trep,
                                                              jrep)
        assert trep["n_frames"] == jrep["n_frames"]


# ------------------------------------------------------ (d) the extraction


def test_batched_extraction_matches_single():
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.superpoint import LAYERS

    cfg = _merge_dataclass(Config(), {"camera": {"width": 128, "height": 96},
                                      "tracking": {"num_features": 100},
                                      "runtime": {"max_keypoints": 128}})
    gen = torch.Generator().manual_seed(3)
    state = {}
    for name, cin, cout, k in LAYERS:
        state[f"{name}.weight"] = torch.randn(
            (cout, cin, k, k), generator=gen) * (2.0 / (cin * k * k)) ** 0.5
        state[f"{name}.bias"] = torch.randn((cout,), generator=gen) * 0.01
    run = make_extractor(cfg, state, device="cpu")
    rng = np.random.default_rng(4)
    imgs = rng.random((2, 96, 128), np.float32)
    single = run(imgs[:1])
    batch = run(imgs)
    assert int(single.count[0]) == int(batch.count[0]) > 0
    np.testing.assert_allclose(single.uv[0].numpy(), batch.uv[0].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(single.desc[0].numpy(), batch.desc[0].numpy(),
                               atol=1e-4)


# ---------------------------------------------------------- (e), (f): R1, R2


def test_fleet_scrubs_replaced_points_in_last_frame():
    cfg = _cfg()
    stream = list(SyntheticDataset(cfg, n_frames=12, seed=3))
    fleet = StreamFleet(cfg, 1, params=None, device="cpu")
    for raw in stream[:10]:
        fleet.tick([raw])
    t = fleet.systems[0].tracker
    assert t.state == ttr.OK
    last = t.last_frame
    bound = [int(p) for p in last.mp_ids if p >= 0]
    old, rep = t.map.points[bound[0]], t.map.points[bound[1]]
    t.map.replace_point(old, rep)
    fleet.tick([stream[10]])
    # the JAX package's single-stream path rewrites the stale id to its
    # replacement before the coarse stage reads the bindings
    assert old.pid not in last.mp_ids
    assert rep.pid in last.mp_ids


def test_bankify_rejects_mixed_rows_and_keys_by_composition():
    cfg = _cfg()
    fleet = StreamFleet(cfg, 3, params=None, device="cpu")
    banks = [torch.full((8, 256), float(i)) for i in range(3)]
    rows_np = np.zeros(4, np.int32)
    valid = np.ones(4, bool)

    def row(i, version=0):
        return (np.eye(4, dtype=np.float32), np.zeros((4, 3), np.float32),
                tk.BankRows(rows_np, valid, banks[i], version), valid)

    mixed = [row(0), (np.eye(4), np.zeros((4, 3)), torch.zeros(4, 256),
                      valid)]
    with pytest.raises(ValueError, match="disagree on bank mode"):
        fleet._bankify(mixed)
    a, bank_a = fleet._bankify([row(0), row(1)])
    b, bank_b = fleet._bankify([row(2), row(0), row(1)])
    assert bank_a and bank_b
    assert len(fleet._bank_stacks) == 2     # two compositions, two stacks
    assert a[0][-1] is a[1][-1] and a[0][-1] is not b[0][-1]
    assert torch.equal(b[0][-1].array[:, 0, 0], torch.tensor([2., 0., 1.]))
    again, _ = fleet._bankify([row(0), row(1)])
    assert again[0][-1] is a[0][-1]          # the same composition: cached
    bumped, _ = fleet._bankify([row(0, version=1), row(1)])
    assert bumped[0][-1] is not a[0][-1]     # an in-place bank update


def test_idle_rows_repeat_row_0_contiguously():
    """The tick's image batch keeps the fleet width: idle rows repeat row 0
    and the batch is one contiguous tensor (the kernels take no other)."""
    fleet = StreamFleet(_cfg(), 3, params=None, device="cpu")
    fleet._extractors = {fleet.device: (None, lambda images: images)}
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (240, 320), np.uint8) for _ in range(2)]
    batch = fleet._extract_batch(imgs)
    assert batch.shape == (3, 240, 320) and batch.is_contiguous()
    assert torch.equal(batch[2], batch[0])
    assert fleet.last_extract_placement == dict(
        n_rows=3, split=False, slots=1, devices=["cpu"])
    np.testing.assert_array_equal(batch[1].numpy(),
                                  imgs[1].astype(np.float32) / 255.0)


def test_fleet_needs_one_card_and_no_mesh():
    """A mesh slot on the card extracts there or raises: without a card the
    fleet never falls back to the CPU for it (the mesh itself is
    tests/test_torch_mesh.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    from sp_orb_slam_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamFleet(_cfg(), 2, params={}, device="cpu",
                    mesh=Mesh(["cuda:0", "cuda:0"]))
