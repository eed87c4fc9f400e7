"""The extractor's remaining options in the port against the JAX package,
on the CPU:

(a) `dense_covariance` (cov_method="dense": basin-ownership labels and
    5x5-cell moment sums) at atol 1e-5 on tests/test_extractor.py:245's
    peaked map, and on a seeded batch of two such maps through the batched
    port (the JAX function per image);
(b) `extract` with cov_method "dense" and "none", and with every value of
    the JAX package's `emission` and `heat_shuffle` lowerings, against the
    JAX package's `extract` on the same images and parameters (96x128,
    K=128: tests/test_torch_extractor.py's size and tolerances); unknown
    values raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.extractor import extract as jextract
from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.ops import covariance as jcov
from sp_orb_slam_tpu_torch.extractor import extract
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.ops import covariance as tcov

torch.set_num_threads(2)

H, W, NF, K = 96, 128, 100, 128


def _peaked(rng, n_kp=30, h=96, w=128, cell=8):
    """tests/test_extractor.py:245-265's input: keypoints one per inner
    cell, a Gaussian peak at each over low noise, normalised."""
    hc, wc = h // cell, w // cell
    inner = [r * wc + c for r in range(2, hc - 2) for c in range(2, wc - 2)]
    cells = rng.choice(inner, n_kp, replace=False)
    uv = np.stack([(cells % wc) * 8 + rng.integers(2, 6, n_kp),
                   (cells // wc) * 8 + rng.integers(2, 6, n_kp)],
                  -1).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    heat = rng.random((h, w)).astype(np.float32) * 0.05
    for (u, v) in uv:
        heat += np.exp(-((xx - u) ** 2 + (yy - v) ** 2)
                       / 6.0).astype(np.float32)
    heat /= heat.max()
    occ = np.full((hc, wc), -1, np.int32)
    for k, (u, v) in enumerate(uv):
        occ[int(v) // 8, int(u) // 8] = k
    return heat, occ, uv, np.ones(n_kp, bool)


def _check_dense(batch):
    got = tcov.dense_covariance(*(torch.from_numpy(np.stack(x))
                                  for x in zip(*batch)), iters=16)
    for b, (heat, occ, uv, valid) in enumerate(batch):
        want = jcov.dense_covariance(jnp.asarray(heat), jnp.asarray(occ),
                                     jnp.asarray(uv), jnp.asarray(valid),
                                     iters=16)
        for g, w, name in zip(got, want, ("cov2", "cov2_inv", "response")):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                       atol=1e-5, err_msg=f"{name} {b}")
    return got


def test_dense_covariance_matches_jax():
    cov2, _, resp = _check_dense([_peaked(np.random.default_rng(11))])
    assert (cov2.numpy() >= 1.0).all() and (resp.numpy() > 0.5).all()


def test_dense_covariance_batch_matches_jax():
    """Two maps in one batched call, the second with invalid keypoint
    slots (unit covariance, zero response)."""
    rng = np.random.default_rng(5)
    a, b = _peaked(rng), _peaked(rng, n_kp=24)
    valid = b[3].copy()
    valid[::5] = False
    b = (b[0], b[1], b[2], valid)
    b_pad = (b[0], b[1], np.concatenate([b[2], np.zeros((6, 2),
                                                         np.float32)]),
             np.concatenate([b[3], np.zeros(6, bool)]))
    cov2, _, resp = _check_dense([a, b_pad])
    assert (cov2[1].numpy()[~b_pad[3]] == 1.0).all()
    assert (resp[1].numpy()[~b_pad[3]] == 0.0).all()


@pytest.fixture(scope="module")
def jparams():
    return jsp.init_params(jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((2, H, W), np.float32)


def _both(jparams, images, **kw):
    jf = jextract(jparams, jnp.asarray(images), num_features=NF,
                  max_keypoints=K, **kw)
    with torch.no_grad():
        tf = extract(SuperPoint(params_from_jax(jparams)),
                     torch.from_numpy(images), num_features=NF,
                     max_keypoints=K, **kw)
    return jf, tf


def _same(jf, tf, fields=("cov2", "cov2_inv", "response")):
    for f in ("uv", "valid", "occ_grid", "count"):
        np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                      np.asarray(getattr(jf, f)), err_msg=f)
    assert int(tf.count.min()) > 20
    for f in ("desc", "score") + tuple(fields):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("cov_method", ["dense", "none"])
def test_extract_cov_methods_match_jax(jparams, images, cov_method):
    jf, tf = _both(jparams, images, cov_method=cov_method)
    _same(jf, tf)
    np.testing.assert_allclose(tf.response.numpy(), np.asarray(jf.response),
                               atol=1e-5)
    if cov_method == "none":
        assert (tf.cov2.numpy() == 1.0).all()
        assert (tf.cov2_inv.numpy() == 1.0).all()
        assert (tf.response.numpy() == 0.0).all()
    else:
        valid = tf.valid.numpy()
        assert (tf.cov2.numpy() >= 1.0).all()
        assert (tf.response.numpy()[valid] > 0.0).all()


@pytest.mark.parametrize("kw", [dict(emission="sort"),
                                dict(emission="scatter"),
                                dict(heat_shuffle="slices", with_heat=True),
                                dict(heat_shuffle="transpose",
                                     with_heat=True)],
                         ids=["sort", "scatter", "slices", "transpose"])
def test_extract_lowerings_match_jax(jparams, images, kw):
    jf, tf = _both(jparams, images, **kw)
    _same(jf, tf)
    if kw.get("with_heat"):
        np.testing.assert_allclose(tf.heat.numpy(), np.asarray(jf.heat),
                                   atol=1e-4)
        np.testing.assert_allclose(tf.heat_inv.numpy(),
                                   np.asarray(jf.heat_inv), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(cov_method="bogus"),
                                dict(emission="bogus"),
                                dict(heat_shuffle="bogus")],
                         ids=["cov_method", "emission", "heat_shuffle"])
def test_extract_rejects_unknown_lowerings(jparams, images, kw):
    with pytest.raises(ValueError, match="unknown"):
        extract(SuperPoint(params_from_jax(jparams)),
                torch.from_numpy(images), num_features=NF, max_keypoints=K,
                **kw)
