"""conv_packing "s2d", "s2d2" and "s2d3" (the JAX package's space-to-depth
lowerings of the first 1, 2 or 3 conv pairs, which the port runs as its
unpacked "none" route: the same function, faster on the H100) against the
JAX package's forward with the same packing and against the port's "none",
on the CPU at full channel widths (B=2, 64x96), at the tolerances of the
JAX package's golden s2d test (tests/test_extractor.py:372-387)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.extractor import make_extractor
from sp_orb_slam_tpu_torch.models import superpoint as tsp
from sp_orb_slam_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

H, W = 64, 96
PACKINGS = ("s2d", "s2d2", "s2d3")


@pytest.fixture(scope="module")
def jparams():
    return jsp.init_params(jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def model(jparams):
    return tsp.SuperPoint(params_from_jax(jparams)).eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).random((2, H, W), np.float32)


@pytest.fixture(scope="module")
def plain(model, images):
    with torch.no_grad():
        return model(torch.from_numpy(images))


def _golden(got, want):
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.semi_dust),
                               np.asarray(want.semi_dust), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.coarse_desc),
                               np.asarray(want.coarse_desc), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.cand_uv),
                                  np.asarray(want.cand_uv))


@pytest.mark.parametrize("packing", PACKINGS)
def test_s2d_matches_jax_and_none(jparams, model, images, plain, packing):
    with torch.no_grad():
        got = model(torch.from_numpy(images), conv_packing=packing)
    want = jsp.forward(jparams, jnp.asarray(images), conv_packing=packing)
    _golden(got, want)
    _golden(got, plain)


@pytest.mark.parametrize("packing", PACKINGS)
def test_s2d_bfloat16(jparams, model, images, packing):
    """bfloat16 against the JAX package's bfloat16 forward with the same
    packing, at bfloat16's rounding of the conv stack: semi_dust within
    0.03 and coarse_desc within 0.005 (the port's and JAX's unpacked
    bfloat16 forwards part by 0.016 and 0.0019 here); and equal to the
    port's unpacked bfloat16 forward, the route it runs."""
    with torch.no_grad():
        got = model(torch.from_numpy(images), conv_packing=packing,
                    compute_dtype=torch.bfloat16)
        none = model(torch.from_numpy(images), compute_dtype=torch.bfloat16)
    want = jsp.forward(jparams, jnp.asarray(images), conv_packing=packing,
                       compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.semi_dust.numpy(),
                               np.asarray(want.semi_dust), atol=3e-2)
    np.testing.assert_allclose(got.coarse_desc.numpy(),
                               np.asarray(want.coarse_desc), atol=5e-3)
    assert torch.equal(got.semi_dust, none.semi_dust)
    assert torch.equal(got.coarse_desc, none.coarse_desc)
    assert got.score.dtype == torch.float32
    assert torch.isfinite(got.coarse_desc).all()


@pytest.mark.parametrize("packing", PACKINGS)
def test_extractor_s2d_keypoints_equal_none(jparams, images, packing):
    cfg = Config()
    ex = {}
    for p in ("none", packing):
        run = make_extractor(dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor,
                                               conv_packing=p)),
            params_from_jax(jparams), device="cpu")
        ex[p] = run(images)
    a, b = ex["none"], ex[packing]
    assert int(a.count.sum()) > 0
    assert torch.equal(a.uv, b.uv) and torch.equal(a.count, b.count)
    assert torch.equal(a.desc, b.desc)
