"""Port parity of descriptor sampling: the CPU paths of the port's two
sampling wrappers (ops/cuda_desc.py, which run the plain versions
`sample_descriptors_sparse_plain` and models/superpoint.py
`sample_descriptors_dense`) against the JAX package's Pallas kernels in
interpret mode, the forward's raw descriptor map, and the extractor's four
`desc_method` routes against each other, on the CPU at small shapes.

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
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint, unit_rows
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
        torch.from_numpy(coarse), torch.from_numpy(uv),
        torch.ones((B, K), dtype=torch.bool), (H, W)).numpy()
    assert got.shape == (B, K, 256)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,K", [(1, 64, 96, 24), (2, 48, 200, 16)])
def test_sparse_raw_matches_jax(dtype, B, H, W, K):
    """The fused function from the raw map (rows of any norm, float32 or
    bfloat16) against the JAX package's path: the map normalised as its
    models/superpoint.py does, the Pallas kernel in interpret mode, then
    the valid mask.  The bfloat16 map goes to JAX as the float32 values of
    its rounded entries.  Keypoints anywhere in the image and at its four
    corners; a valid prefix of each image's slots, the rest exactly 0."""
    rng = np.random.default_rng(B * H + W)
    hc, wc = H // 8, W // 8
    scale = np.exp(rng.normal(size=(B, hc, wc, 1)))
    raw_t = torch.from_numpy(
        (rng.normal(size=(B, hc, wc, 256)) * scale).astype(np.float32))
    raw_t = raw_t.to(dtype)
    raw = raw_t.float().numpy()
    uv = np.stack([rng.uniform(0, W - 1, (B, K)),
                   rng.uniform(0, H - 1, (B, K))], -1).astype(np.float32)
    uv[:, :4] = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]]
    n = rng.integers(K // 2, K, B)
    valid = np.arange(K)[None, :] < n[:, None]
    unit = jnp.asarray(raw) / jnp.linalg.norm(jnp.asarray(raw), axis=-1,
                                              keepdims=True)
    want = np.asarray(jnp.where(
        jnp.asarray(valid)[..., None],
        pallas_desc.pallas_sample_descriptors_sparse(
            unit, jnp.asarray(uv), image_hw=(H, W), interpret=True), 0.0))
    got = cuda_desc.sample_descriptors_sparse(
        raw_t, torch.from_numpy(uv), torch.from_numpy(valid),
        (H, W)).numpy()
    assert got.shape == (B, K, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[~valid] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=-1), 1.0,
                               atol=ATOL)


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
def model_images():
    params = params_from_jax(jsp.init_params(jax.random.PRNGKey(3)))
    images = torch.from_numpy(
        np.random.default_rng(5).random((2, H, W), np.float32))
    return SuperPoint(params), images


@pytest.fixture(scope="module")
def gather_run(model_images):
    model, images = model_images

    def run(method, dtype=torch.float32):
        with torch.no_grad():
            return extract(model, images, num_features=NF, max_keypoints=K,
                           desc_method=method, compute_dtype=dtype)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extract_pallas_sparse_from_raw_map(gather_run, dtype):
    """The pallas_sparse route, which hands the sampler the forward's raw
    map, against "gather" in each compute dtype: the same keypoints and
    counts, descriptors within 1e-5, invalid slots exactly 0."""
    run, _ = gather_run
    ref, got = run("gather", dtype), run("pallas_sparse", dtype)
    assert torch.equal(got.uv, ref.uv)
    assert torch.equal(got.count, ref.count)
    assert int(ref.count.min()) > 20
    np.testing.assert_allclose(got.desc.numpy(), ref.desc.numpy(),
                               atol=ATOL, rtol=0)
    assert (got.desc[~got.valid] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_raw_desc(model_images, dtype):
    """raw_desc=True returns convDb's output in the compute dtype, as a
    contiguous NHWC view, whose unit rows are the default coarse_desc."""
    model, images = model_images
    with torch.no_grad():
        unit = model(images, compute_dtype=dtype).coarse_desc
        raw = model(images, compute_dtype=dtype, raw_desc=True).coarse_desc
    assert raw.dtype == dtype and raw.shape == unit.shape
    assert raw.is_contiguous()
    assert not torch.allclose(raw.float().norm(dim=-1),
                              torch.ones(raw.shape[:-1]))
    np.testing.assert_allclose(unit_rows(raw.float()).numpy(), unit.numpy(),
                               atol=1e-6, rtol=0)


def test_extract_rejects_unknown_desc_method(gather_run):
    run, _ = gather_run
    with pytest.raises(ValueError, match="unknown desc_method"):
        run("bogus")
