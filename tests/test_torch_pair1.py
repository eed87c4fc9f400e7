"""Port parity of the row-pair first conv pair (conv_packing="pair1",
sp_orb_slam_tpu_torch/ops/cuda_pair1.py) against the JAX package's Pallas
kernel `fused_pair1` in interpret mode, on the CPU, in bfloat16.

A CPU tensor takes the wrapper's plain version, the stock bf16 pair.  The
tolerances are tests/test_pallas_pair1.py:37-41's: both sides use bf16
operands, f32 sums, f32 bias + relu and a bf16 store, and differ only in
the f32 summation order, so outputs agree within atol 0.03 / rtol 0.02 and
more than 95 % are bit-identical.  The forward pass through the pair1
route agrees with the JAX package's pair1 forward as in :44-56 (score atol
0.02, more than 98 % of cand_uv equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.ops import pallas_pair1
from sp_orb_slam_tpu_torch.models import superpoint as tsp
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.ops import cuda_pair1

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 48, 640)])
def test_pair1_route_matches_pallas(shape):
    B, H, W = shape
    jp = jsp.init_params(jax.random.PRNGKey(0))
    state = params_from_jax(jp)
    images = np.random.default_rng(1).random((B, H, W), np.float32)
    want = np.asarray(pallas_pair1.fused_pair1(
        jnp.asarray(images), jp, interpret=True), np.float32)
    got = cuda_pair1.fused_pair1(
        torch.from_numpy(images), state["conv1a.weight"],
        state["conv1a.bias"], state["conv1b.weight"], state["conv1b.bias"])
    assert got.dtype == torch.bfloat16
    assert got.shape == (B, H // 2, W // 2, 64)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0.02)
    assert (got == want).mean() > 0.95


def test_pair1_rejects_odd_shapes_and_float32():
    z = torch.zeros(1, 12, 16)
    w = (torch.zeros(64, 1, 3, 3), torch.zeros(64),
         torch.zeros(64, 64, 3, 3), torch.zeros(64))
    with pytest.raises(ValueError, match="H % 8"):
        cuda_pair1.fused_pair1(z, *w)
    model = tsp.SuperPoint(params_from_jax(jsp.init_params(
        jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="bfloat16"):
        model(torch.zeros(1, 16, 16), conv_packing="pair1")


def test_forward_pair1_matches_jax_forward():
    jp = jsp.init_params(jax.random.PRNGKey(2))
    images = np.random.default_rng(3).random((1, 120, 160), np.float32)
    j = jsp.forward(jp, jnp.asarray(images), compute_dtype=jnp.bfloat16,
                    conv_packing="pair1")
    with torch.no_grad():
        t = tsp.SuperPoint(params_from_jax(jp))(
            torch.from_numpy(images), compute_dtype=torch.bfloat16,
            conv_packing="pair1")
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               atol=0.02)
    assert (t.cand_uv.numpy() == np.asarray(j.cand_uv)).mean() > 0.98
