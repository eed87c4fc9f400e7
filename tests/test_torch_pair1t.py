"""Port parity: the fused first conv pair's plain version
(sp_orb_slam_tpu_torch/ops/cuda_pair1t.py) against the JAX package's
Pallas kernel `fused_pair1t` in interpret mode, on the CPU, in bfloat16.

Both sides round at the same places (bf16 input and weights, f32 sums,
f32 bias + relu, bf16 y1, bf16 output); only the f32 summation order
differs, so outputs agree within one bf16 ulp (rtol 1e-2, plus atol 1e-3
for outputs near zero) and almost all are bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.ops import pallas_pair1t
from sp_orb_slam_tpu_torch.models import superpoint as tsp
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.ops import cuda_pair1t

torch.set_num_threads(2)


def _within_one_ulp(got, want):
    err = np.abs(got - want)
    assert (err <= 1e-2 * np.abs(want) + 1e-3).all(), err.max()
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 48, 160)])
def test_pair1t_plain_matches_pallas(shape):
    B, H, W = shape
    jp = jsp.init_params(jax.random.PRNGKey(0))
    state = params_from_jax(jp)
    images = np.random.default_rng(1).random((B, H, W), np.float32)
    want = np.asarray(pallas_pair1t.fused_pair1t(
        jnp.asarray(images), jp, interpret=True), np.float32)
    # a CPU tensor takes the plain version
    got = cuda_pair1t.fused_pair1t(
        torch.from_numpy(images), state["conv1a.weight"],
        state["conv1a.bias"], state["conv1b.weight"], state["conv1b.bias"])
    assert got.dtype == torch.bfloat16
    assert got.shape == (B, H // 2, W // 2, 64)
    _within_one_ulp(got.float().numpy(), want)


def test_pair1t_rejects_odd_shapes():
    z = torch.zeros(1, 12, 16)
    w = torch.zeros(64, 1, 3, 3), torch.zeros(64), torch.zeros(
        64, 64, 3, 3), torch.zeros(64)
    with pytest.raises(ValueError):
        cuda_pair1t.fused_pair1t(z, *w)


def test_forward_pair1t_matches_jax_bf16_pair():
    """The port's bf16 forward with conv_packing='pair1t' feeds the pooled
    pair-1 output to the rest of the stack: its score map agrees with the
    JAX package's pair1t forward to bf16 precision."""
    jp = jsp.init_params(jax.random.PRNGKey(2))
    images = np.random.default_rng(3).random((1, 64, 96), np.float32)
    j = jsp.forward(jp, jnp.asarray(images), compute_dtype=jnp.bfloat16,
                    conv_packing="pair1t")
    with torch.no_grad():
        t = tsp.SuperPoint(params_from_jax(jp))(
            torch.from_numpy(images), compute_dtype=torch.bfloat16,
            conv_packing="pair1t")
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               atol=0.02)
    assert (t.cand_uv.numpy() == np.asarray(j.cand_uv)).mean() > 0.95


@pytest.mark.parametrize("shape,tiles", [
    ((32, 480, 752), 32 * 240 * 6),  # the step: a ragged band of 112
    ((2, 480, 752), 2 * 240 * 6),    # the pair1t frontend's batch
    ((1, 480, 640), 240 * 5),        # whole bands
    ((1, 48, 200), 24 * 2),          # a ragged band of 72
])
def test_pair1t_tiles(shape, tiles):
    """The kernel's tiles: 2 full-resolution rows x 128 columns, the right
    band ragged; the persistent grid is min(tiles, SMs x blocks)."""
    assert cuda_pair1t.tiles(*shape) == tiles


def test_pair1t_cpu_route_packs_nothing():
    """A CPU tensor takes the plain version and leaves pair1's packed-weight
    cache alone (the kernel shares that cache with the pair1 kernel)."""
    from sp_orb_slam_tpu_torch.ops import cuda_pair1

    rng = np.random.default_rng(6)
    w = [torch.from_numpy(rng.standard_normal(s, np.float32))
         for s in ((64, 1, 3, 3), (64,), (64, 64, 3, 3), (64,))]
    n = cuda_pair1.packs
    got = cuda_pair1t.fused_pair1t(torch.rand(1, 16, 24), *w)
    assert got.shape == (1, 8, 12, 64)
    assert cuda_pair1.packs == n


def test_pair1t_kernel_shape_rules():
    """Off the CPU the kernel loads input rows by TMA (16-byte row strides):
    W % 4 == 0, checked before anything reaches a card; the row product's
    shift must leave 128 pixels."""
    w = (torch.zeros(64, 1, 3, 3), torch.zeros(64), torch.zeros(
        64, 64, 3, 3), torch.zeros(64))
    with pytest.raises(ValueError, match="W % 4"):
        cuda_pair1t.fused_pair1t(torch.zeros(1, 16, 22, device="meta"), *w)
    wt = torch.zeros(64, 64, dtype=torch.bfloat16)
    y = torch.zeros(144, 64, dtype=torch.bfloat16)
    for shift in (-1, 17):
        with pytest.raises(ValueError, match="shift"):
            cuda_pair1t.row_product(wt, y, shift)
