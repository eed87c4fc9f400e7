"""The port's NetVLAD (models/netvlad.py) against the JAX package's.

The parameters are built by numpy in both packages and must be equal; the
port's module aggregates on its device in full float32 and is held to
`global_descriptor` (the JAX package's device form) and
`global_descriptor_np` (its host form, the one the JAX System runs) at
atol 1e-5, on the vectors and on the pairwise dot products the loop
detector thresholds (the 0.2 floor, 0.75 x the best accumulated score).
Then the keyframe-promotion hook and its System wiring, as
tests/test_netvlad.py checks them in the JAX package."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import netvlad as jvlad
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.models import netvlad as tvlad

VLAD_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "vlad_rendered.npz")


def _cfg(**over):
    return _merge_dataclass(Config(), {
        "dataset": "synthetic",
        "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                   "cx": 160.0, "cy": 120.0, "fps": 20.0},
        "tracking": {"num_features": 250},
        "runtime": {"max_keypoints": 256}, **over})


def _assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_init_params_equal_jax():
    _assert_params_equal(tvlad.init_params(3, out_dim=512),
                         jvlad.init_params(3, out_dim=512))
    _assert_params_equal(tvlad.init_params(0), jvlad.init_params(0))


@pytest.fixture(scope="module")
def trained():
    if not os.path.exists(VLAD_WEIGHTS):
        pytest.skip("fitted VLAD checkpoint not present")
    return tvlad.load_params(VLAD_WEIGHTS)


def test_load_params_equal_jax(trained):
    _assert_params_equal(trained, jvlad.load_params(VLAD_WEIGHTS))
    assert trained["proj"].shape == (64 * 256, 4096)
    assert float(np.abs(trained["mean"]).max()) > 0


def _descs(rng, B, K):
    desc = rng.normal(0, 1, (B, K, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.random((B, K)) > 0.3
    return desc, valid


@pytest.mark.parametrize("which", ["random", "trained"])
def test_module_matches_jax_vectors_and_scores(rng, which, request):
    """Both regimes: random init (residual 0, no centering) and the fitted
    checkpoint (residual 1, centered)."""
    params = (tvlad.init_params(0) if which == "random"
              else request.getfixturevalue("trained"))
    desc, valid = _descs(rng, 6, 128)
    # two near-revisits of frame 0: most descriptors shared
    desc[1, :100] = desc[0, :100]
    desc[2, :60] = desc[0, :60]
    model = tvlad.NetVLAD(params, device="cpu")
    out = model(torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    assert out.shape == (6, 4096)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    g_np = np.stack([jvlad.global_descriptor_np(params, d, v)
                     for d, v in zip(desc, valid)])
    g_jax = np.asarray(jvlad.batched_global_descriptor(
        params, jnp.asarray(desc), jnp.asarray(valid)))
    for ref in (g_np, g_jax):
        np.testing.assert_allclose(out, ref, atol=1e-5)
        np.testing.assert_allclose(out @ out.T, ref @ ref.T, atol=1e-5)
    # one frame at a time is the batched form's row
    one = model(torch.from_numpy(desc[3]), torch.from_numpy(valid[3]))
    np.testing.assert_allclose(one.numpy(), out[3], atol=1e-6)
    # invalid keypoints do not contribute
    desc2 = desc[0].copy()
    desc2[~valid[0]] = rng.normal(0, 1, (int((~valid[0]).sum()), 256))
    g2 = model(torch.from_numpy(desc2), torch.from_numpy(valid[0])).numpy()
    np.testing.assert_allclose(g2, out[0], atol=1e-5)


def _frame(fid, K=16, desc=None):
    from sp_orb_slam_tpu_torch.slam.frame import FrameData

    if desc is None:
        desc = np.zeros((K, 256), np.float32)
        desc[:, fid % 256] = 1.0
    return FrameData(
        frame_id=fid, timestamp=fid / 20.0,
        uv=np.zeros((K, 2), np.float32), score=np.zeros(K, np.float32),
        response=np.zeros(K, np.float32), valid=np.ones(K, bool),
        cov2_inv=np.ones((K, 2), np.float32),
        occ_grid=np.full((30, 40), -1, np.int32), count=K,
        desc_dev=torch.from_numpy(desc), dust_dev=None, occ_grid_dev=None,
        Tcw=np.eye(4, dtype=np.float32))


def test_keyframe_promotion_hook():
    """Map.add_keyframe applies global_desc_fn: "auto" fills only missing
    descriptors; the hook returning None leaves the frame untouched."""
    from sp_orb_slam_tpu_torch.slam.map import Map

    world = Map(mp_capacity=16)
    calls = []

    def fn(frame):
        calls.append(frame.frame_id)
        if frame.global_desc is not None:
            return None
        return np.ones(8, np.float32)

    world.global_desc_fn = fn
    kf0 = world.add_keyframe(_frame(0))
    assert kf0.global_desc is not None and calls == [0]
    preset = np.full(8, 0.5, np.float32)
    f1 = _frame(1)
    f1.global_desc = preset
    kf1 = world.add_keyframe(f1)
    np.testing.assert_array_equal(kf1.global_desc, preset)
    assert calls == [0, 1]
    # the hook and the lock survive a clear (System.reset)
    lock = world.update_lock
    world.clear()
    assert world.global_desc_fn is fn and world.update_lock is lock


def test_system_wires_vlad_source():
    """The System installs the hook when loop closing is on and the source
    is not dataset-only, and the hook computes what the JAX System's
    host hook computes for the same keyframe."""
    from sp_orb_slam_tpu_torch.slam.system import System

    s = System(_cfg(use_loop=True, loop={"use_loop": True}), device="cpu")
    assert s.map.global_desc_fn is not None
    f = _frame(0, K=64, desc=_descs(np.random.default_rng(0), 1, 64)[0][0])
    gd = s.map.global_desc_fn(f)
    ref = jvlad.global_descriptor_np(jvlad.init_params(0), f.desc_host,
                                     f.valid)
    np.testing.assert_allclose(gd, ref, atol=1e-5)
    f.global_desc = gd
    assert s.map.global_desc_fn(f) is None  # "auto" keeps a descriptor

    s2 = System(_cfg(use_loop=True, loop={"use_loop": True,
                                          "global_desc_source": "dataset"}),
                device="cpu")
    assert s2.map.global_desc_fn is None
    s3 = System(_cfg(), device="cpu")
    assert s3.map.global_desc_fn is None and s3.looper is None


def test_discriminates_revisit_on_loop_rail():
    """The port's module on the port's synthetic loop rail: revisit frames
    score high against the start, the far side low (test_netvlad.py's
    gate on the JAX package)."""
    from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset

    cfg = _cfg()
    ds = SyntheticDataset(cfg, n_frames=32, n_points=9000, seed=2,
                          pixel_noise=0.1, loop=True)
    model = tvlad.NetVLAD(tvlad.init_params(0), device="cpu")

    def gd(i):
        inj = ds.frame(i).injected
        return model(torch.from_numpy(inj["desc"]),
                     torch.from_numpy(inj["valid"])).numpy()

    g0, g_far, g_end = gd(0), gd(16), gd(31)
    same, diff = float(g0 @ g_end), float(g0 @ g_far)
    assert same > diff + 0.2, (same, diff)
    assert same > 0.5, same
