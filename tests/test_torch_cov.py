"""Port parity: the covariance flood fill (sp_orb_slam_tpu_torch/ops/
covariance.py, the plain version behind ops/cuda_cov.py) against the JAX
package's Pallas kernel `pallas_covariance` (interpret mode), its XLA
`keypoint_covariance` and the BFS golden, on the CPU.  `response` is exact;
`cov2` agrees to atol 1e-5 (f32 sums in another order)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_orb_slam_tpu.ops import covariance as jcov
from sp_orb_slam_tpu.ops import pallas_cov
from sp_orb_slam_tpu_torch.ops import covariance as tcov
from sp_orb_slam_tpu_torch.ops import cuda_cov

torch.set_num_threads(2)


def _inputs(seed, B=2, H=96, W=128, K=64, plateaus=False):
    rng = np.random.default_rng(seed)
    heat = rng.random((B, H, W), np.float32)
    if plateaus:  # exact ties between neighbours test the strict descent
        heat = (np.round(heat * 8) / 8).astype(np.float32)
    uv = np.stack([rng.integers(8, W - 8, (B, K)),
                   rng.integers(8, H - 8, (B, K))], -1).astype(np.float32)
    valid = rng.random((B, K)) > 0.2
    return heat, uv, valid


@pytest.mark.parametrize("plateaus", [False, True])
def test_cov_matches_pallas_and_xla(plateaus):
    heat, uv, valid = _inputs(11, plateaus=plateaus)
    with pltpu.force_tpu_interpret_mode():
        c_p, ci_p, r_p = pallas_cov.pallas_covariance(
            jnp.asarray(heat), jnp.asarray(uv), jnp.asarray(valid),
            radius=8, iters=16)
    c_x, _, r_x = jax.vmap(partial(jcov.keypoint_covariance, radius=8,
                                   iters=16))(
        jnp.asarray(heat), jnp.asarray(uv), jnp.asarray(valid))
    # a CPU tensor takes the plain fill
    c, ci, r = cuda_cov.batched_covariance(
        torch.from_numpy(heat), torch.from_numpy(uv),
        torch.from_numpy(valid), radius=8, iters=16)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_p))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_x))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_p), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(ci_p), rtol=1e-5,
                               atol=1e-6)
    assert (c.numpy()[~valid] == 1.0).all() and (r.numpy()[~valid] == 0).all()


def test_cov_matches_bfs_golden():
    """Peaked map: the bounded fill equals the window-bounded sequential
    BFS once every descent path is resolved (iters >= window span)."""
    rng = np.random.default_rng(9)
    h, w = 64, 64
    heat = rng.random((h, w), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for cx, cy in [(20, 20), (40, 35)]:
        heat += 2.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                             / 18.0).astype(np.float32)
    heat /= heat.max()
    uv = np.array([[20, 20], [40, 35], [10, 50]], np.float32)
    valid = np.array([True, True, True])
    c, _, r = tcov.keypoint_covariance(
        torch.from_numpy(heat)[None], torch.from_numpy(uv)[None],
        torch.from_numpy(valid)[None], radius=8, iters=24)
    ref_c, _, ref_r = tcov.covariance_reference(heat, uv, valid, radius=8)
    np.testing.assert_allclose(r[0].numpy(), ref_r, atol=1e-6)
    np.testing.assert_allclose(c[0].numpy(), ref_c, rtol=1e-5)
    jref = jcov.covariance_reference(heat, uv, valid, radius=8)
    np.testing.assert_array_equal(ref_c, jref[0])


def test_cov_window_clips_at_image_edge():
    """Invalid slots sit at (0, 0): their window clips to the corner, as
    `_window_gather` does in the JAX package."""
    heat, uv, valid = _inputs(5, B=1, K=16)
    uv[0, :4] = 0.0
    c_x, _, r_x = jax.vmap(partial(jcov.keypoint_covariance, radius=8,
                                   iters=16))(
        jnp.asarray(heat), jnp.asarray(uv), jnp.asarray(np.ones_like(valid)))
    c, _, r = tcov.keypoint_covariance(
        torch.from_numpy(heat), torch.from_numpy(uv),
        torch.from_numpy(np.ones_like(valid)), radius=8, iters=16)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_x))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_x), rtol=0, atol=1e-5)


def _descent_path(B=1, H=64, W=64, K=16, at=(24, 20)):
    """A heat map that is 0 (never reached) but for a strictly descending
    path from keypoint 0 at `at`: 8 pixels right, to the window's edge,
    then 8 down, so the fill needs exactly 16 rounds; the other keypoints
    anywhere, a third of them invalid."""
    rng = np.random.default_rng(3)
    heat = np.zeros((B, H, W), np.float32)
    u0, v0 = at
    path = [(u0 + s, v0) for s in range(9)] + [(u0 + 8, v0 + s)
                                               for s in range(1, 9)]
    for s, (u, v) in enumerate(path):
        heat[:, v, u] = 1.0 - 0.05 * s
    uv = np.stack([rng.integers(8, W - 8, (B, K)),
                   rng.integers(8, H - 8, (B, K))], -1).astype(np.float32)
    uv[:, 0] = at
    valid = rng.random((B, K)) > 0.33
    valid[:, 0] = True
    return heat, uv, valid


@pytest.mark.parametrize("iters", [15, 16])
def test_cov_descent_path_of_16(iters):
    """The fill after 15 rounds stops one pixel short of the path's end,
    after 16 it reaches it: the plain fill equals the Pallas kernel
    (interpret mode) at both, and the two differ."""
    heat, uv, valid = _descent_path()
    args = [torch.from_numpy(x) for x in (heat, uv, valid)]
    # the plain fill stops growing after 16 rounds, not before
    c15, c16, c17 = (tcov.keypoint_covariance(*args, radius=8, iters=k)[0]
                     for k in (15, 16, 17))
    assert (c15[0, 0] != c16[0, 0]).any() and torch.equal(c16, c17)
    with pltpu.force_tpu_interpret_mode():
        c_p, ci_p, r_p = pallas_cov.pallas_covariance(
            jnp.asarray(heat), jnp.asarray(uv), jnp.asarray(valid),
            radius=8, iters=iters)
    c, ci, r = cuda_cov.batched_covariance(*args, radius=8, iters=iters)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_p))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_p), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(ci_p), rtol=1e-5,
                               atol=1e-6)
    other = cuda_cov.batched_covariance(*args, radius=8,
                                        iters=31 - iters)[0]
    assert (c[0, 0] != other[0, 0]).any()
