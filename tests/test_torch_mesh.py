"""The port's stream mesh (parallel/mesh.py) and the fleet over it, on the
CPU, where a mesh of n CPU slots stands for the JAX package's n virtual
CPU devices (tests/test_mesh.py, tests/test_fleet.py:189-262): the rows
are split into one contiguous chunk per slot exactly as across cards.

(a) `make_mesh`: n CPU slots; for the card it raises when the cards are
    too few (no fallback); slots that repeat a device split like distinct
    ones;
(b) the port's `multi_stream_step` against the JAX package's on the same
    inputs (float32, SuperPoint init_params carried by params_from_jax):
    features, matches and inlier counts equal, uv within 1e-4, Tcw within
    1e-5;
(c) the sharded step on 8 slots equals the unsharded step (bfloat16, the
    JAX test's dtype; match and inlier counts equal, Tcw 1e-5, uv 1e-4),
    and permuting the streams permutes its outputs;
(d) the mapper's batches split over the mesh equal the plain ones, and a
    width the slot count does not divide runs unsplit;
(e) an 8-stream injected fleet on an 8-slot mesh equals the fleet without
    one stream for stream, with its dust and local stages split; a
    2-stream image fleet (rendered rooms, trained weights) on a 2-slot
    mesh extracts split over both slots and tracks with 0 LOST.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.extractor import extract as jextract
from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.parallel import mesh as jmesh
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.parallel import mesh as pm
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.fleet import StreamFleet
from sp_orb_slam_tpu_torch.slam.kernels import PreStacked, TrackingKernels
from test_torch_system import SMALL, WEIGHTS

torch.set_num_threads(2)

B, H, W, K, NF = 8, 64, 96, 128, 100
SHIFT = 8  # pixels between a stream's previous and current image: one cell
K_INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)


# ------------------------------------------------------------- (a) meshes


def test_make_mesh_cpu_fleet():
    mesh = pm.make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.axis_names == ("stream",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.distinct() == [torch.device("cpu")]
    assert pm.make_mesh(device_type="cpu").size == 1


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(ValueError, match="need 2 CUDA device"):
        pm.make_mesh(2, "cuda")
    with pytest.raises(ValueError, match="need 1 CUDA device"):
        pm.make_mesh()  # the default is every card
    with pytest.raises(ValueError, match="at least one"):
        pm.make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="unknown device_type"):
        pm.make_mesh(1, "tpu")


def test_mesh_slots_and_split():
    mesh = pm.Mesh(["cuda:0", "cuda", "cuda:1"])
    assert mesh.devices[:2] == (torch.device("cuda", 0),) * 2
    assert mesh.distinct() == [torch.device("cuda", 0),
                               torch.device("cuda", 1)]
    assert [(str(d), lo, hi) for d, lo, hi in mesh.split(6)] == [
        ("cuda:0", 0, 2), ("cuda:0", 2, 4), ("cuda:1", 4, 6)]
    with pytest.raises(ValueError, match="do not split"):
        mesh.split(4)
    with pytest.raises(ValueError, match="at least one"):
        pm.Mesh([])


# ---------------------------------------------------------- (b), (c) step


@pytest.fixture(scope="module")
def jparams():
    return jsp.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def inputs(jparams):
    """Each stream's current image is its previous one moved by SHIFT
    pixels; the previous frame's features come from the JAX extractor and
    its points sit on a plane at a per-stream depth, so every stream has
    matches and inliers."""
    rng = np.random.default_rng(0)
    big = rng.random((B, H, W + SHIFT), np.float32)
    cur, prev = big[:, :, :W].copy(), big[:, :, SHIFT:].copy()
    pf = jextract(jparams, jnp.asarray(prev), num_features=NF,
                  max_keypoints=K, compute_dtype=jnp.float32)
    desc, uv, valid = (np.array(pf.desc), np.array(pf.uv),
                       np.array(pf.valid))
    z = np.broadcast_to((3.0 + 0.25 * np.arange(B, dtype=np.float32))[:, None],
                        valid.shape)
    mp_pos = np.stack([(uv[..., 0] - K_INTR[2]) / K_INTR[0] * z,
                       (uv[..., 1] - K_INTR[3]) / K_INTR[1] * z, z], -1)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    return (cur, desc, uv, valid, Tcw, mp_pos.astype(np.float32),
            valid.copy(), K_INTR)


def _port_step(jparams, inputs, dtype):
    model = SuperPoint(params_from_jax(jparams)).eval()
    return pm.multi_stream_step(
        model, *map(torch.from_numpy, inputs),
        num_features=NF, max_keypoints=K, compute_dtype=dtype)


def _assert_steps_equal(a, b, tcw_atol=1e-5, perm=slice(None)):
    fa, ma, na, Ta, ia = (x if i == 0 else np.asarray(x)
                          for i, x in enumerate(a))
    fb, mb, nb, Tb, ib = (x if i == 0 else np.asarray(x)
                          for i, x in enumerate(b))
    np.testing.assert_array_equal(ma[perm], mb)
    np.testing.assert_array_equal(na[perm], nb)
    np.testing.assert_array_equal(ia[perm], ib)
    np.testing.assert_allclose(Ta[perm], Tb, rtol=0, atol=tcw_atol)
    np.testing.assert_allclose(np.asarray(fa.uv)[perm], np.asarray(fb.uv),
                               rtol=0, atol=1e-4)


def test_multi_stream_step_matches_jax(jparams, inputs):
    want = jax.jit(lambda p, *a: jmesh.multi_stream_step(
        p, *a, num_features=NF, max_keypoints=K,
        compute_dtype=jnp.float32))(jparams, *map(jnp.asarray, inputs))
    got = _port_step(jparams, inputs, torch.float32)
    _assert_steps_equal(got, want)
    np.testing.assert_array_equal(got[0].valid.numpy(),
                                  np.asarray(want[0].valid))
    assert got[2].min() > 20 and got[4].min() > 10  # matches, inliers


def test_sharded_step_matches_unsharded(jparams, inputs):
    mesh = pm.make_mesh(8, "cpu")
    step = pm.build_sharded_step(mesh, params_from_jax(jparams),
                                 num_features=NF, max_keypoints=K)
    sharded = step(*inputs)
    assert all(t.device.type == "cpu" for t in sharded[1:])
    plain = _port_step(jparams, inputs, torch.bfloat16)
    _assert_steps_equal(sharded, plain)
    assert sharded[2].min() > 20


def test_sharded_step_on_repeated_slots(jparams, inputs):
    """Two slots of one device split as two devices would: the same
    answer as one slot and as the unsharded step."""
    plain = _port_step(jparams, inputs, torch.bfloat16)
    for mesh in (pm.Mesh(["cpu", "cpu"]), pm.make_mesh(1, "cpu")):
        step = pm.build_sharded_step(mesh, params_from_jax(jparams),
                                     num_features=NF, max_keypoints=K)
        _assert_steps_equal(step(*inputs), plain)
    step = pm.build_sharded_step(pm.make_mesh(3, "cpu"),
                                 params_from_jax(jparams), num_features=NF,
                                 max_keypoints=K)
    with pytest.raises(ValueError, match="do not split"):
        step(*inputs)


def test_sharded_step_streams_independent(jparams, inputs):
    """Permuting streams permutes outputs: no stream leaks into another
    through the split."""
    perm = np.asarray([3, 1, 4, 0, 7, 5, 2, 6])
    permuted = tuple(a[perm] if a.ndim and a.shape[0] == B else a
                     for a in inputs)
    step = pm.build_sharded_step(pm.make_mesh(8, "cpu"),
                                 params_from_jax(jparams), num_features=NF,
                                 max_keypoints=K)
    _assert_steps_equal(step(*inputs), step(*permuted), perm=perm)


# ------------------------------------------------------ (d) mapper batches


def _mapper_kernels():
    cfg = _merge_dataclass(Config(), {
        "camera": {"width": 96, "height": 64, "fx": 80.0, "fy": 80.0,
                   "cx": 48.0, "cy": 32.0, "fps": 20.0},
        "tracking": {"num_features": 60},
        "runtime": {"max_keypoints": 64, "dust_points_cap": 64,
                    "local_points_cap": 128}})
    return TrackingKernels(cfg, device="cpu")


def _tri_rows(n, Kp, rng):
    """Keyframe pairs seeing the same points: keypoints at depths 2-5 in
    the first camera, projected into the second (moved by 0.3-0.65 along
    x and 0.1 along z, so that the epipole is finite) with the same
    descriptors."""
    def row(i):
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, 3] = [0.3 + 0.05 * i, 0.0, 0.1]
        uv1 = rng.uniform(8, 88, (Kp, 2)).astype(np.float32)
        z = rng.uniform(2, 5, Kp)
        X = np.stack([(uv1[:, 0] - K_INTR[2]) / K_INTR[0] * z,
                      (uv1[:, 1] - K_INTR[3]) / K_INTR[1] * z, z], -1)
        X2 = X + T2[:3, 3]
        uv2 = (K_INTR[:2] * X2[:, :2] / X2[:, 2:]
               + K_INTR[2:]).astype(np.float32)
        d = rng.normal(size=(Kp, 256)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        cov = np.ones((Kp, 2), np.float32)
        free = np.ones(Kp, bool)
        return (np.eye(4, dtype=np.float32), T2, uv1, d, cov, free, uv2, d,
                cov, free)

    return [row(i) for i in range(n)]


def test_mapper_batches_split_over_mesh():
    kernels = _mapper_kernels()
    rows = _tri_rows(8, kernels.cfg.runtime.max_keypoints,
                     np.random.default_rng(1))
    plain = kernels.triangulate_pair_batch(rows)
    assert kernels.last_batch_placement["tri"]["split"] is False

    kernels.batch_mesh = pm.make_mesh(8, "cpu")
    split = kernels.triangulate_pair_batch(rows)
    pl = kernels.last_batch_placement["tri"]
    assert pl == dict(n_rows=8, split=True, slots=8, devices=["cpu"] * 8)
    for a, b in zip(plain, split):
        np.testing.assert_array_equal(a["match21"], b["match21"])
        np.testing.assert_allclose(a["points"], b["points"], atol=1e-5)
        np.testing.assert_array_equal(a["good"], b["good"])
    assert sum(int(a["n_good"]) for a in split) > 0
    # a width-2 batch does not split over 8 slots: it runs as one
    kernels.triangulate_pair_batch(rows[:2])
    assert kernels.last_batch_placement["tri"]["split"] is False
    kernels.batch_mesh = pm.make_mesh(2, "cpu")
    kernels.triangulate_pair_batch(rows[:2])
    assert kernels.last_batch_placement["tri"]["slots"] == 2


def test_split_batches_cut_prestacked_arguments():
    """A split batch hands each chunk its own rows of a PreStacked
    argument (the fleet's stacked features and banks)."""
    kernels = _mapper_kernels()
    Kp = kernels.cfg.runtime.max_keypoints
    rows = _tri_rows(4, Kp, np.random.default_rng(2))
    descs = PreStacked(torch.from_numpy(np.stack([r[3] for r in rows])))
    stacked = [r[:3] + (descs,) + r[4:7] + (descs,) + r[8:] for r in rows]
    want = kernels.triangulate_pair_batch(rows)
    kernels.batch_mesh = pm.make_mesh(4, "cpu")
    got = kernels.triangulate_pair_batch(stacked)
    assert kernels.last_batch_placement["tri"]["slots"] == 4
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a["match21"], b["match21"])
        np.testing.assert_allclose(a["points"], b["points"], atol=1e-5)


# ------------------------------------------------------------ (e) fleets


def test_fleet_batched_stages_split_over_mesh():
    cfg = _merge_dataclass(Config(), SMALL)
    n, n_frames = 8, 10
    streams = [list(SyntheticDataset(cfg, n_frames=n_frames, seed=s))
               for s in range(n)]

    def drive(mesh):
        fleet = StreamFleet(cfg, n, params=None, device="cpu", mesh=mesh)
        poses = [[] for _ in range(n)]
        for k in range(n_frames):
            for i, p in enumerate(fleet.tick([st[k] for st in streams])):
                if p is not None:
                    poses[i].append(p)
        fleet.shutdown()
        return fleet, poses

    fleet_s, poses_s = drive(pm.make_mesh(8, "cpu"))
    assert fleet_s.n_batched_dust > 0 and fleet_s.n_batched_local > 0
    assert fleet_s.kernels.batch_mesh is fleet_s.mesh
    placed = fleet_s.kernels.last_batch_placement
    assert placed["dust"]["split"] and placed["dust"]["slots"] == 8
    local = [placed[k] for k in ("local", "local_wide") if k in placed]
    assert local and all(p["split"] for p in local if p["n_rows"] == n)

    fleet_u, poses_u = drive(None)
    assert fleet_u.kernels.last_batch_placement["dust"]["split"] is False
    for i in range(n):
        assert len(poses_s[i]) == len(poses_u[i]) > 0, i
        for a, b in zip(poses_s[i], poses_u[i]):
            np.testing.assert_allclose(a, b, atol=5e-4)


def test_fleet_rejects_a_mesh_that_does_not_split_its_streams():
    with pytest.raises(ValueError, match="do not split"):
        StreamFleet(_merge_dataclass(Config(), SMALL), 3, params=None,
                    device="cpu", mesh=pm.make_mesh(2, "cpu"))


@pytest.mark.skipif(not os.path.exists(WEIGHTS),
                    reason="trained checkpoint not present")
def test_image_fleet_on_two_slot_mesh():
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg = _merge_dataclass(Config(), {
        "camera": {"width": 376, "height": 240, "fx": 178.05, "fy": 209.0,
                   "cx": 181.38, "cy": 125.09}})
    n_ticks = 24
    rooms = [RenderedDataset(cfg, n_frames=220, seed=s, noise_seed=0)
             for s in (4, 5)]
    fleet = StreamFleet(cfg, 2, params=load_checkpoint(WEIGHTS),
                        device="cpu", mesh=pm.Mesh(["cpu", "cpu"]))
    for k in range(n_ticks):
        fleet.tick([r.frame(k) for r in rooms])
    fleet.shutdown()
    assert fleet.last_extract_placement == dict(
        n_rows=2, split=True, slots=2, devices=["cpu", "cpu"])
    for i, rep in enumerate(fleet.report()):
        assert fleet.systems[i].tracker.state == ttr.OK, (i, rep)
        assert rep["n_lost"] == 0 and rep["n_keyframes"] >= 2, (i, rep)
