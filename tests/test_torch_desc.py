"""Port parity of descriptor sampling: the CPU paths of the port's two
sampling wrappers (ops/cuda_desc.py, which run the plain versions
`sample_descriptors` and `sample_descriptors_dense` of
models/superpoint.py) against the JAX package's Pallas kernels in
interpret mode, and the extractor's four `desc_method` routes against each
other, on the CPU at small shapes.

Tolerance: atol 1e-5, the JAX package's own golden tests' bound
(tests/test_pallas_desc.py); the routes differ only in float32 summation
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.ops import pallas_desc
from sp_orb_slam_tpu_torch.extractor import extract
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.ops import cuda_desc

torch.set_num_threads(2)

ATOL = 1e-5


def _coarse(rng, B, hc, wc):
    c = rng.normal(size=(B, hc, wc, 256)).astype(np.float32)
    return c / np.linalg.norm(c, axis=-1, keepdims=True)


def _cand_uv(rng, B, hc, wc):
    """Each cell's candidate inside its own 8x8 cell, as the frontend
    emits them."""
    u = np.arange(wc)[None, None, :] * 8 + rng.integers(0, 8, (B, hc, wc))
    v = np.arange(hc)[None, :, None] * 8 + rng.integers(0, 8, (B, hc, wc))
    return np.stack([u, v], -1).astype(np.int32)


@pytest.mark.parametrize("B,H,W,K", [(2, 64, 96, 16), (1, 48, 200, 24)])
def test_sparse_plain_matches_pallas(B, H, W, K):
    rng = np.random.default_rng(H + W)
    hc, wc = H // 8, W // 8
    coarse = _coarse(rng, B, hc, wc)
    # keypoints anywhere in the image, plus the four extreme corners
    uv = np.stack([rng.uniform(0, W - 1, (B, K)),
                   rng.uniform(0, H - 1, (B, K))], -1).astype(np.float32)
    uv[:, :4] = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]]
    want = np.asarray(pallas_desc.pallas_sample_descriptors_sparse(
        jnp.asarray(coarse), jnp.asarray(uv), image_hw=(H, W),
        interpret=True))
    got = cuda_desc.sample_descriptors_sparse(
        torch.from_numpy(coarse), torch.from_numpy(uv), (H, W)).numpy()
    assert got.shape == (B, K, 256)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,H,W", [(2, 64, 96), (1, 40, 56)])
def test_dense_plain_matches_pallas(B, H, W):
    rng = np.random.default_rng(H * W)
    hc, wc = H // 8, W // 8
    coarse = _coarse(rng, B, hc, wc)
    cand = _cand_uv(rng, B, hc, wc)
    want = np.asarray(pallas_desc.pallas_sample_descriptors_dense(
        jnp.asarray(coarse), jnp.asarray(cand), image_hw=(H, W),
        interpret=True))
    got = cuda_desc.sample_descriptors_dense_batch(
        torch.from_numpy(coarse), torch.from_numpy(cand), (H, W)).numpy()
    assert got.shape == (B, hc, wc, 256)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # and the JAX package's plain stencil, per image
    ref = np.stack([np.asarray(jsp.sample_descriptors_dense(
        jnp.asarray(coarse[b]), jnp.asarray(cand[b]), (H, W)))
        for b in range(B)])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


H, W, NF, K = 96, 128, 100, 128


@pytest.fixture(scope="module")
def gather_run():
    params = params_from_jax(jsp.init_params(jax.random.PRNGKey(3)))
    model = SuperPoint(params)
    images = torch.from_numpy(
        np.random.default_rng(5).random((2, H, W), np.float32))

    def run(method):
        with torch.no_grad():
            return extract(model, images, num_features=NF, max_keypoints=K,
                           desc_method=method)

    return run, run("gather")


@pytest.mark.parametrize("method", ["pallas_sparse", "pallas", "dense",
                                    "auto"])
def test_extract_desc_methods_agree(gather_run, method):
    run, ref = gather_run
    got = run(method)
    assert torch.equal(got.uv, ref.uv)
    assert torch.equal(got.count, ref.count)
    assert int(ref.count.min()) > 20
    np.testing.assert_allclose(got.desc.numpy(), ref.desc.numpy(),
                               atol=ATOL, rtol=0)


def test_extract_rejects_unknown_desc_method(gather_run):
    run, _ = gather_run
    with pytest.raises(ValueError, match="unknown desc_method"):
        run("bogus")
