"""Port parity of the first conv pair's pair1 route (conv_packing="pair1",
sp_orb_slam_tpu_torch/ops/cuda_pair1.py) against the JAX package's Pallas
kernel `fused_pair1` in interpret mode, on the CPU, in bfloat16; the
wrapper's weight packing and the `auto` choice.

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


def _unpack_w1b(packed):
    """The inverse of cuda_pair1.pack_w1b: (9, 64, 64) -> OIHW."""
    idx = cuda_pair1.swizzle_index().expand(9, 64, 64)
    wb = torch.empty_like(packed).scatter_(2, idx, packed)
    return wb.reshape(3, 3, 64, 64).permute(2, 3, 0, 1)


def test_pair1_weight_packing_roundtrips():
    """The kernel's conv1b layout, [tap = dy*3+dx][co][ci] bf16 with the
    16-byte chunk j of each co row stored at chunk j ^ (co % 8), unpacks to
    the OIHW weights exactly; conv1a packs as [co][tap] with taps 9..15
    zero."""
    rng = np.random.default_rng(4)
    w1b = torch.from_numpy(rng.standard_normal((64, 64, 3, 3), np.float32))
    w1a = torch.from_numpy(rng.standard_normal((64, 1, 3, 3), np.float32))
    packed = cuda_pair1.pack_w1b(w1b)
    assert packed.shape == (9, 64, 64) and packed.dtype == torch.bfloat16
    assert torch.equal(_unpack_w1b(packed), w1b.to(torch.bfloat16))
    # the swizzle itself: chunk j of row (tap, co) sits at chunk j ^ (co % 8)
    ref = w1b.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 64, 8, 8)
    for co in (0, 5, 13, 63):
        for j in range(8):
            assert torch.equal(packed[:, co, 8 * (j ^ (co % 8)):][:, :8],
                               ref[:, co, j])
    wa = cuda_pair1.pack_w1a(w1a)
    assert torch.equal(wa[:, :9], w1a.to(torch.bfloat16).reshape(64, 9))
    assert not wa[:, 9:].any()


def test_pair1_packing_is_cached():
    """One packing for repeated calls with the same weight tensors; a new
    tensor, or an in-place update of a cached one, packs anew."""
    rng = np.random.default_rng(5)
    w = [torch.from_numpy(rng.standard_normal(s, np.float32))
         for s in ((64, 1, 3, 3), (64,), (64, 64, 3, 3), (64,))]
    cpu = torch.device("cpu")
    first = cuda_pair1.packed_weights(*w, cpu)
    n = cuda_pair1.packs
    for _ in range(3):
        assert cuda_pair1.packed_weights(*w, cpu) is first
    assert cuda_pair1.packs == n
    w[2].mul_(2.0)
    again = cuda_pair1.packed_weights(*w, cpu)
    assert cuda_pair1.packs == n + 1 and again is not first
    assert torch.equal(_unpack_w1b(again[2]),
                       w[2].to(torch.bfloat16))
    other = [t.clone() for t in w]
    cuda_pair1.packed_weights(*other, cpu)
    assert cuda_pair1.packs == n + 2
    with torch.inference_mode():
        frozen = [t.clone() for t in w]
    cuda_pair1.packed_weights(*frozen, cpu)
    cuda_pair1.packed_weights(*frozen, cpu)
    assert cuda_pair1.packs == n + 4


def test_model_holds_its_pair1_packing():
    """Each SuperPoint module packs its own conv1a and conv1b once a device
    and keeps them: another module's packing, or the wrappers' one-entry
    cache taking other weights, leaves them as they were (a captured CUDA
    graph reads them)."""
    cpu = torch.device("cpu")
    m1, m2 = (tsp.SuperPoint(tsp.init_params(torch.Generator().manual_seed(s)))
              for s in (1, 2))
    n = cuda_pair1.packs
    p1 = m1._pair1_packed(cpu)
    assert m1._pair1_packed(cpu) is p1 and cuda_pair1.packs == n + 1
    keep = [t.clone() for t in p1]
    m2._pair1_packed(cpu)
    cuda_pair1.packed_weights(m2.conv1a.weight, m2.conv1a.bias,
                              m2.conv1b.weight, m2.conv1b.bias, cpu)
    assert m1._pair1_packed(cpu) is p1 and cuda_pair1.packs == n + 3
    want = cuda_pair1.pack(m1.conv1a.weight, m1.conv1a.bias,
                           m1.conv1b.weight, m1.conv1b.bias, cpu)
    for a, b, c in zip(p1, keep, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not any(t.is_inference() for t in p1)
    assert torch.equal(_unpack_w1b(p1[2]), m1.conv1b.weight.detach().to(
        torch.bfloat16))


@pytest.mark.parametrize("dtype,device,hw,want", [
    (torch.bfloat16, "cuda", (480, 752), "pair1"),
    (torch.bfloat16, "cuda", (480, 640), "pair1"),
    (torch.bfloat16, "cuda", (484, 752), "none"),
    (torch.float32, "cuda", (480, 752), "none"),
    (torch.bfloat16, "cpu", (480, 752), "none"),
])
def test_auto_conv_packing_takes_pair1(dtype, device, hw, want):
    """conv_packing="auto" takes the persistent pair1 kernel on the bf16
    CUDA path where its shape rule holds, and the plain convs elsewhere;
    an explicit choice is kept."""
    from sp_orb_slam_tpu_torch.extractor import resolve_conv_packing

    dev = torch.device(device)
    assert resolve_conv_packing("auto", dtype, dev, *hw) == want
    assert resolve_conv_packing("pair1t", dtype, dev, *hw) == "pair1t"
