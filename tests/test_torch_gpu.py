"""Kernel tests of the port on the card: each hand-written CUDA kernel
against its plain PyTorch version.  Marked `gpu`; each test decides in the
`cuda` fixture whether a card is present and skips without one.  Imports
only torch and the port, so it runs on a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import collections
import dataclasses
import os

import pytest
import torch
import torch.nn.functional as F

from sp_orb_slam_tpu_torch.models.superpoint import (
    sample_descriptors, sample_descriptors_dense)
from sp_orb_slam_tpu_torch.ops import (_build, cuda_cov, cuda_desc,
                                       cuda_match, cuda_nms, cuda_pair1,
                                       cuda_pair1t)
from sp_orb_slam_tpu_torch.ops.covariance import keypoint_covariance
from sp_orb_slam_tpu_torch.ops.matching import init_match
from sp_orb_slam_tpu_torch.ops.nms import greedy_grid_nms

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture()
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 48, 200), (3, 480, 752),
                                   (8, 480, 752), (1, 480, 640),
                                   (2, 480, 752)])
def test_pair1t_kernel(cuda, gen, shape):
    """The transposed-GEMM kernel against its plain version: conv1b's f32
    sums in another order, so a value may move one bf16 ulp (rtol 1e-2,
    atol 1e-3, > 99 % bit-identical).  Shapes: pair1's, with the fleet's
    (8, 480, 752), whose right band is ragged (752 = 5 x 128 + 112), 640
    columns (whole bands), 200 (a ragged band of 72), and the pair1t
    path's batch (2, 480, 752).  At least one block fits on an SM and the
    grid is min(tiles, SMs x blocks)."""
    B, H, W = shape
    images = torch.rand(shape, generator=gen, device=cuda)
    w = [torch.randn(s, generator=gen, device=cuda) * sc
         for s, sc in (((64, 1, 3, 3), 0.5), ((64,), 0.1),
                       ((64, 64, 3, 3), 0.05), ((64,), 0.1))]
    n = _build.LAUNCHES["pair1t"]
    got = cuda_pair1t.fused_pair1t(images, *w).float()
    want = cuda_pair1t.fused_pair1t_plain(images, *w).float()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair1t"] == n + 1
    assert got.shape == (B, H // 2, W // 2, 64)
    assert ((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all()
    assert (got == want).float().mean() > 0.99
    grid, blocks, sms = cuda_pair1t.launch_grid(B, H, W, cuda)
    assert blocks >= 1
    assert grid == min(cuda_pair1t.tiles(B, H, W), sms * blocks)


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 7, 8, 9, 15])
def test_pair1t_row_product_shift(cuda, gen, shift):
    """conv1b's B operand shifted by whole pixels (128 bytes each) inside
    the 128-byte swizzle atom, as a tap's column offset moves it: one k
    pass of the kernel's product equals the f32 matrix product of the
    same bf16 values (the products are exact, the sums in another order)."""
    w = torch.randn((64, 64), generator=gen, device=cuda).to(torch.bfloat16)
    y = torch.randn((144, 64), generator=gen, device=cuda).to(torch.bfloat16)
    packed = torch.gather(w, 1, cuda_pair1.swizzle_index().to(cuda))
    n = _build.LAUNCHES["pair1t"]
    got = cuda_pair1t.row_product(packed.contiguous(), y, shift)
    want = w.float() @ y[shift:shift + 128].float().T
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert _build.LAUNCHES["pair1t"] == n


def test_pair1t_shares_pair1_packing(cuda, gen):
    """pair1t launches on the pair1 kernel's packed weights: the first of
    the two wrappers to see a set of weights packs it, the other reuses it."""
    images = torch.rand((1, 48, 200), generator=gen, device=cuda)
    w = [torch.randn(s, generator=gen, device=cuda) * sc
         for s, sc in (((64, 1, 3, 3), 0.5), ((64,), 0.1),
                       ((64, 64, 3, 3), 0.05), ((64,), 0.1))]
    n = cuda_pair1.packs
    cuda_pair1t.fused_pair1t(images, *w)
    cuda_pair1.fused_pair1(images, *w)
    cuda_pair1t.fused_pair1t(images, *w)
    assert cuda_pair1.packs == n + 1


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 48, 200), (3, 480, 752),
                                   (8, 480, 752), (1, 480, 640)])
def test_pair1_kernel(cuda, gen, shape):
    """The persistent kernel against its plain version (the tolerances of
    tests/test_pallas_pair1.py: f32 sums in another order, atol 0.03 /
    rtol 0.02, > 95 % bit-identical) and against the pair1t kernel, which
    computes the same function.  Shapes: the fleet's (8, 480, 752), whose
    right column band is ragged (752 = 11 x 64 + 48), 640 columns (whole
    bands) and 200 (a ragged band of 8).  At least one block fits on an SM
    and the grid is min(tiles, SMs x blocks)."""
    B, H, W = shape
    images = torch.rand(shape, generator=gen, device=cuda)
    w = [torch.randn(s, generator=gen, device=cuda) * sc
         for s, sc in (((64, 1, 3, 3), 0.5), ((64,), 0.1),
                       ((64, 64, 3, 3), 0.05), ((64,), 0.1))]
    n = _build.LAUNCHES["pair1"]
    got = cuda_pair1.fused_pair1(images, *w).float()
    want = cuda_pair1.fused_pair1_plain(images, *w).float()
    other = cuda_pair1t.fused_pair1t(images, *w).float()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pair1"] == n + 1
    assert got.shape == (B, H // 2, W // 2, 64)
    for ref in (want, other):
        assert ((got - ref).abs() <= 0.02 * ref.abs() + 0.03).all()
        assert (got == ref).float().mean() > 0.95
    grid, blocks, sms = cuda_pair1.launch_grid(B, H, W, cuda)
    assert blocks >= 1
    assert grid == min(cuda_pair1.tiles(B, H, W), sms * blocks)


def test_pair1_packs_once(cuda, gen):
    """Repeated calls with the same weights pack them once; the card's
    packing of conv1b's weights is the CPU's, bit for bit."""
    images = torch.rand((1, 48, 200), generator=gen, device=cuda)
    w = [torch.randn(s, generator=gen, device=cuda) * sc
         for s, sc in (((64, 1, 3, 3), 0.5), ((64,), 0.1),
                       ((64, 64, 3, 3), 0.05), ((64,), 0.1))]
    cuda_pair1.fused_pair1(images, *w)
    n = cuda_pair1.packs
    for _ in range(3):
        cuda_pair1.fused_pair1(images, *w)
    assert cuda_pair1.packs == n
    wb = cuda_pair1.packed_weights(*w, cuda)[2]
    assert torch.equal(wb.cpu(), cuda_pair1.pack_w1b(w[2].cpu()))


@pytest.mark.parametrize("iters", [1, 4, 16])
def test_nms_kernel(cuda, gen, iters):
    B, hc, wc = 4, 60, 94
    score = torch.round(torch.rand((B, hc, wc), generator=gen, device=cuda)
                        * 50) / 50
    u = torch.arange(wc, device=cuda) * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    v = torch.arange(hc, device=cuda)[:, None] * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    uv = torch.stack([u, v], -1).to(torch.int32).contiguous()
    valid = torch.rand((B, hc, wc), generator=gen, device=cuda) < 0.7
    got = cuda_nms.batched_grid_nms(score, uv, valid, iters=iters)
    want = greedy_grid_nms(score, uv, valid, iters=iters)
    assert torch.equal(got, want)


def test_cov_kernel(cuda, gen):
    B, H, W, K = 2, 96, 128, 256
    heat = torch.round(torch.rand((B, H, W), generator=gen, device=cuda)
                       * 16) / 16
    uv = torch.stack([torch.randint(0, W, (B, K), generator=gen, device=cuda),
                      torch.randint(0, H, (B, K), generator=gen,
                                    device=cuda)], -1).float().contiguous()
    valid = torch.rand((B, K), generator=gen, device=cuda) > 0.2
    c, ci, r = cuda_cov.batched_covariance(heat, uv, valid)
    c_p, ci_p, r_p = keypoint_covariance(heat, uv, valid)
    assert torch.equal(r, r_p)
    assert (c - c_p).abs().max() <= 1e-5
    assert torch.allclose(ci, ci_p, rtol=1e-5, atol=1e-6)


def _nms_cells(gen, cuda, B, hc, wc, p_valid=0.7):
    """Cells with forced score ties, one candidate inside each cell."""
    score = torch.round(torch.rand((B, hc, wc), generator=gen, device=cuda)
                        * 50) / 50
    u = torch.arange(wc, device=cuda) * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    v = torch.arange(hc, device=cuda)[:, None] * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    uv = torch.stack([u, v], -1).to(torch.int32).contiguous()
    valid = torch.rand((B, hc, wc), generator=gen, device=cuda) < p_valid
    return score, uv, valid


@pytest.mark.parametrize("iters", [0, 1, 16])
@pytest.mark.parametrize("B,hc,wc", [(1, 60, 94), (3, 47, 155), (2, 5, 32)])
def test_nms_kernel_shapes(cuda, gen, B, hc, wc, iters):
    """B=1; 1241x376 (155 columns: a ragged last word); a width of exactly
    one word; no round, one, and the config's 16."""
    score, uv, valid = _nms_cells(gen, cuda, B, hc, wc)
    n = _build.LAUNCHES["nms"]
    got = cuda_nms.batched_grid_nms(score, uv, valid, iters=iters)
    assert _build.LAUNCHES["nms"] == n + 1
    assert torch.equal(got, greedy_grid_nms(score, uv, valid, iters=iters))


@pytest.mark.parametrize("cluster", [1, cuda_nms.CLUSTER])
def test_nms_kernel_cluster(cuda, gen, cluster):
    """Both cluster sizes the launcher has (blocks an image, each masking a
    band of rows), whatever the wrapper picks, with 47 rows (bands of 5 to
    47 rows) and a long chain."""
    for score, uv, valid in (_nms_cells(gen, cuda, 3, 47, 155),
                             _nms_chain(cuda, 2, 47, 94)):
        for iters in (0, 16, 200):
            kept = cuda_nms._launch(score, uv, valid, 4, iters, cluster)
            assert torch.equal(kept, greedy_grid_nms(score, uv, valid,
                                                     iters=iters))


def _nms_chain(cuda, B, hc, wc):
    """tests/test_torch_nms.py `_chain`: a zigzag path of conflicting cells
    in rows 0 and 1 along a monotone score ramp, 2 wc rounds to converge;
    the other rows invalid."""
    k = torch.arange(2 * wc, device=cuda)
    r, c = k % 2, k // 2
    score = torch.zeros((B, hc, wc), device=cuda)
    uv = torch.zeros((B, hc, wc, 2), dtype=torch.int32, device=cuda)
    valid = torch.zeros((B, hc, wc), dtype=torch.bool, device=cuda)
    score[:, r, c] = 1.0 - k / (4.0 * wc)
    uv[:, r, c, 0] = (8 * c + 3 + 4 * r).to(torch.int32)
    uv[:, r, c, 1] = (7 + r).to(torch.int32)
    valid[:, r, c] = True
    return score, uv, valid


@pytest.mark.parametrize("iters", [16, 187, 188, 400])
def test_nms_kernel_long_chain(cuda, iters):
    """A chain across 60x94 that needs 188 rounds: the kernel stops after
    `iters` rounds where the fixed point is not reached, and at it once
    it is, as the plain version does."""
    score, uv, valid = _nms_chain(cuda, 2, 60, 94)
    got = cuda_nms.batched_grid_nms(score, uv, valid, iters=iters)
    assert torch.equal(got, greedy_grid_nms(score, uv, valid, iters=iters))
    assert int(got[0].sum()) == min(iters + 1, 188) // 2


def test_nms_kernel_grid_too_large(cuda):
    """A grid whose words or shared memory do not fit raises, naming the
    sizes, and launches nothing."""
    score = torch.zeros((1, 135, 240), device=cuda)
    uv = torch.zeros((1, 135, 240, 2), dtype=torch.int32, device=cuda)
    valid = torch.zeros((1, 135, 240), dtype=torch.bool, device=cuda)
    n = _build.LAUNCHES["nms"]
    with pytest.raises(ValueError, match="135x240"):
        cuda_nms.batched_grid_nms(score, uv, valid)
    assert _build.LAUNCHES["nms"] == n


def _cov_inputs(gen, cuda, B, H, W, K, p_valid=0.8):
    heat = torch.round(torch.rand((B, H, W), generator=gen, device=cuda)
                       * 16) / 16
    uv = torch.stack([torch.randint(0, W, (B, K), generator=gen, device=cuda),
                      torch.randint(0, H, (B, K), generator=gen,
                                    device=cuda)], -1).float().contiguous()
    valid = torch.rand((B, K), generator=gen, device=cuda) < p_valid
    return heat, uv, valid


def _check_cov(got, want):
    """cov2 within 1e-5 and cov2_inv to rtol 1e-5 (f32 sums in another
    order), the response equal."""
    (c, ci, r), (c_p, ci_p, r_p) = got, want
    assert torch.equal(r, r_p)
    assert (c - c_p).abs().max() <= 1e-5
    assert torch.allclose(ci, ci_p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("radius", [0, 4, 8, 15])
@pytest.mark.parametrize("iters", [0, 1, 16])
def test_cov_kernel_radius(cuda, gen, radius, iters):
    heat, uv, valid = _cov_inputs(gen, cuda, 2, 96, 128, 256)
    n = _build.LAUNCHES["cov"]
    got = cuda_cov.batched_covariance(heat, uv, valid, radius=radius,
                                      iters=iters)
    assert _build.LAUNCHES["cov"] == n + 1
    _check_cov(got, keypoint_covariance(heat, uv, valid, radius=radius,
                                        iters=iters))


def test_cov_kernel_misaligned_uv(cuda, gen):
    """A contiguous uv at an odd float offset raises and launches
    nothing."""
    heat, uv, valid = _cov_inputs(gen, cuda, 2, 96, 128, 256)
    odd = torch.empty(uv.numel() + 1, device=cuda)[1:].view(uv.shape)
    odd.copy_(uv)
    n = _build.LAUNCHES["cov"]
    with pytest.raises(ValueError, match="8-byte aligned uv"):
        cuda_cov.batched_covariance(heat, odd, valid)
    assert _build.LAUNCHES["cov"] == n


def test_cov_kernel_all_invalid(cuda, gen):
    heat, uv, valid = _cov_inputs(gen, cuda, 2, 96, 128, 256, p_valid=0.0)
    c, ci, r = cuda_cov.batched_covariance(heat, uv, valid)
    assert (c == 1).all() and (ci == 1).all() and (r == 0).all()


@pytest.mark.parametrize("iters", [15, 16, 40])
def test_cov_kernel_descent_path_of_16(cuda, iters):
    """tests/test_torch_cov.py `_descent_path` on the card: the path from
    keypoint 0's centre needs exactly 16 rounds."""
    heat = torch.zeros((1, 64, 64), device=cuda)
    u0, v0 = 24, 20
    path = [(u0 + s, v0) for s in range(9)] + [(u0 + 8, v0 + s)
                                               for s in range(1, 9)]
    for s, (u, v) in enumerate(path):
        heat[0, v, u] = 1.0 - 0.05 * s
    uv = torch.tensor([[[u0, v0], [40.0, 30.0]]], device=cuda)
    valid = torch.ones((1, 2), dtype=torch.bool, device=cuda)
    got = cuda_cov.batched_covariance(heat, uv, valid, iters=iters)
    _check_cov(got, keypoint_covariance(heat, uv, valid, iters=iters))


def _match_inputs(gen, cuda, B, M, N, D=256):
    """Unit descriptors, frame 2 noisy copies of frame 1 with its last 16
    rows exact duplicates of its first 16 (distance ties), windows of
    +-60 px around the frame-1 positions, 10 % of each side invalid."""
    d1 = torch.randn((B, M, D), generator=gen, device=cuda)
    d1 = d1 / d1.norm(dim=-1, keepdim=True)
    n = min(M, N)
    d2 = torch.randn((B, N, D), generator=gen, device=cuda)
    d2[:, :n] = d1[:, :n] + 0.015 * d2[:, :n]
    d2 = d2 / d2.norm(dim=-1, keepdim=True)
    d2[:, N - 16:] = d2[:, :16]          # exact duplicates: distance ties
    uv1 = torch.rand((B, M, 2), generator=gen, device=cuda) * 400
    uv2 = torch.rand((B, N, 2), generator=gen, device=cuda) * 400
    uv2[:, :n] = uv1[:, :n] + (uv2[:, :n] / 400 - 0.5) * 120
    v1 = torch.rand((B, M), generator=gen, device=cuda) > 0.1
    v2 = torch.rand((B, N), generator=gen, device=cuda) > 0.1
    return d1, v1, uv1, d2.contiguous(), uv2.contiguous(), v2


def _check_match(args, got):
    g12, gn, g21 = got
    w12, wn, w21 = init_match(*args)
    # full-f32 sums in another order: allow near-ties, none seen at these
    # sizes, so require index equality on all but a handful of rows
    assert (g12 != w12).sum() <= 2
    assert int(gn.sum()) > 0
    assert torch.equal(gn, (g12 >= 0).sum(-1, dtype=torch.int32))
    assert (g21 >= 0).sum() == gn.sum()


@pytest.mark.parametrize("B,M,N", [(2, 256, 256), (2, 200, 136),
                                   (2, 896, 896), (1, 896, 896),
                                   (8, 896, 896), (2, 1000, 904)])
def test_match_kernel(cuda, gen, B, M, N):
    """The kernel against init_match at the tile the wrapper plans: B=1 and
    2 at 896 x 896 take the small split-column tiles, B=8 the 128 x 128
    ones; 200 x 136 and 1000 x 904 leave every tile size a ragged edge."""
    args = _match_inputs(gen, cuda, B, M, N)
    n = _build.LAUNCHES["match"]
    got = cuda_match.match_init_batch(*args)
    assert _build.LAUNCHES["match"] == n + 1
    _check_match(args, got)


@pytest.mark.parametrize("tile", range(len(cuda_match.TILES)))
@pytest.mark.parametrize("B,M,N", [(1, 200, 136), (3, 1000, 904)])
def test_match_kernel_tiles(cuda, gen, tile, B, M, N):
    """Every tile size on ragged shapes, whatever the plan picks."""
    args = _match_inputs(gen, cuda, B, M, N)
    _check_match(args, cuda_match._launch(*args, tile, 100, 0.9, 0.3))


@pytest.mark.parametrize("case", ["outside_window", "frame2_invalid"])
@pytest.mark.parametrize("B,M,N", [(1, 896, 896), (2, 200, 136)])
def test_match_kernel_empty(cuda, gen, case, B, M, N):
    """No pair in reach: every column outside every row's window, or all of
    frame 2 invalid, gives no match on either side."""
    d1, v1, uv1, d2, uv2, v2 = _match_inputs(gen, cuda, B, M, N)
    if case == "outside_window":
        uv2 = (uv2 + 1000.0).contiguous()
    else:
        v2 = torch.zeros_like(v2)
    m12, n, m21 = cuda_match.match_init_batch(d1, v1, uv1, d2, uv2, v2)
    w12, wn, w21 = init_match(d1, v1, uv1, d2, uv2, v2)
    assert int(n.sum()) == 0 and torch.equal(n, wn)
    assert (m12 == -1).all() and (m21 == -1).all()
    assert torch.equal(m12, w12) and torch.equal(m21, w21)


def _coarse(gen, cuda, B, hc, wc):
    c = torch.randn((B, hc, wc, 256), generator=gen, device=cuda)
    return c / c.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,K", [(2, 64, 96, 16), (1, 480, 752, 896),
                                     (32, 480, 752, 896)])
def test_desc_sparse_kernel(cuda, gen, B, H, W, K, dtype):
    """The fused sampler against its plain version on a raw map whose rows
    are not unit (1e-5, invalid rows exactly 0, one launch a call), with a
    valid prefix of each image's slots and keypoints anywhere in the image;
    and on a float32 unit map with every slot valid against
    `sample_descriptors`, the TPU kernel's function."""
    hc, wc = H // 8, W // 8
    raw = (torch.randn((B, hc, wc, 256), generator=gen, device=cuda)
           * torch.rand((B, hc, wc, 1), generator=gen, device=cuda) * 8
           ).to(dtype)
    uv = torch.stack([torch.rand((B, K), generator=gen, device=cuda) * (W - 1),
                      torch.rand((B, K), generator=gen, device=cuda)
                      * (H - 1)], -1).contiguous()
    n = torch.randint(K // 2, K + 1, (B, 1), generator=gen, device=cuda)
    valid = torch.arange(K, device=cuda)[None, :] < n
    before = _build.LAUNCHES["desc_sparse"]
    got = cuda_desc.sample_descriptors_sparse(raw, uv, valid, (H, W))
    want = cuda_desc.sample_descriptors_sparse_plain(raw, uv, valid, (H, W))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["desc_sparse"] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5
    assert (got[~valid] == 0).all()
    unit = _coarse(gen, cuda, B, hc, wc)  # float32, the TPU kernel's input
    every = torch.ones((B, K), dtype=torch.bool, device=cuda)
    got = cuda_desc.sample_descriptors_sparse(unit, uv, every, (H, W))
    want = sample_descriptors(unit, uv, (H, W))
    assert _build.LAUNCHES["desc_sparse"] == before + 2
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("B,H,W", [(2, 64, 96), (32, 480, 752)])
def test_desc_dense_kernel(cuda, gen, B, H, W):
    hc, wc = H // 8, W // 8
    coarse = _coarse(gen, cuda, B, hc, wc)
    u = torch.arange(wc, device=cuda) * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    v = torch.arange(hc, device=cuda)[:, None] * 8 + torch.randint(
        0, 8, (B, hc, wc), generator=gen, device=cuda)
    cand = torch.stack([u, v], -1).to(torch.int32).contiguous()
    n = _build.LAUNCHES["desc_dense"]
    got = cuda_desc.sample_descriptors_dense_batch(coarse, cand, (H, W))
    want = sample_descriptors_dense(coarse, cand, (H, W))
    assert _build.LAUNCHES["desc_dense"] == n + 1
    assert (got - want).abs().max() <= 1e-5


def test_noop_kernel(cuda):
    """The empty kernel that times the launch floor builds, launches through
    the wrappers' path and is counted there."""
    n = _build.LAUNCHES["noop"]
    _build.noop(cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["noop"] == n + 1


def test_train_step_card_vs_cpu(cuda):
    """One training step (train/superpoint_train.py: cuDNN convs, autograd,
    Adam) on the card against the port's CPU path on the same batch, from
    a seeded init at full widths on a small rendered pool: the loss terms,
    all 24 gradients and the updated parameters at chip_smoke.py phase
    11's tolerances (`step_card_vs_cpu` raises past them)."""
    import importlib.util
    import os

    from sp_orb_slam_tpu_torch.models.superpoint import init_params
    from sp_orb_slam_tpu_torch.train import superpoint_train as tt

    pool = tt.build_pool(tt.camera_config(96, 64, 78.0), n_scenes=1,
                         pairs_per_scene=2, seed=0, verbose=False)
    state = init_params(torch.Generator().manual_seed(0))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    lines = chip_smoke.step_card_vs_cpu(
        state, next(tt.batches(pool, 2, seed=0)), cuda)
    assert len(lines) == 1 + 24


# --- the extraction replayed as a CUDA graph (utils/graphs.GraphRunner) ----

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "sp_rendered.npz")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _graph_cfg(dtype):
    from sp_orb_slam_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, dtype=dtype))


def _host_images(B, H=480, W=752, seed=0):
    """Host float32 batches in [0, 1]: seeded noise at the cell scale,
    upsampled, so the trained frontend finds corners."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((B, 1, H // 8, W // 8), generator=g)
    return F.interpolate(coarse, size=(H, W), mode="bilinear",
                         align_corners=False)[:, 0].contiguous().numpy()


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8)))


def _assert_same_features(got, want, what):
    from sp_orb_slam_tpu_torch.extractor import Features

    bad = [f for f, a, b in zip(Features._fields, got, want)
           if not _same_bits(a, b)]
    assert not bad, f"{what}: fields not bit-equal: {bad}"


@pytest.mark.parametrize("dtype,B", [("float32", 1), ("bfloat16", 8),
                                     ("bfloat16", 32)])
def test_graph_replay_bit_equal_to_extract(cuda, dtype, B):
    """Eager, capture, then two replays of one closure on pageable host
    batches, staged through the graph's pinned buffer, each call's
    Features bit-equal in every field to the module's eager `extract` on
    the same batch, read after the last replay."""
    from sp_orb_slam_tpu_torch.extractor import (extract, extract_options,
                                                 make_extractor)
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg = _graph_cfg(dtype)
    state = load_checkpoint(WEIGHTS)
    run = make_extractor(cfg, state, device=cuda)
    batches = [_host_images(B, seed=s) for s in range(4)]
    got = [run(x) for x in batches]
    assert run.calls == {"eager": 1, "capture": 1, "replay": 2}
    assert run.uploads["staged"] == 3    # back to back, a staging copy
                                         # may wait ("waited")
    model = SuperPoint(state).to(cuda).eval()
    with torch.inference_mode():
        want = [extract(model, torch.as_tensor(x, device=cuda),
                        **extract_options(cfg)) for x in batches]
    torch.cuda.synchronize()
    assert int(want[0].count.min()) > 100
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_features(g, w, f"call {i}")


def test_graph_outputs_outlive_the_next_replay(cuda):
    """A call's Features are its own: later replays of the same graph on
    other images leave them as they were."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    run = make_extractor(_graph_cfg("float32"), load_checkpoint(WEIGHTS),
                         device=cuda)
    x0, x1 = _host_images(1, seed=10), _host_images(1, seed=11)
    a, b = run(x0), run(x1)                  # eager, capture
    kept = [None if t is None else t.clone() for t in b]
    c, d = run(x0), run(x1)                  # replays
    torch.cuda.synchronize()
    assert run.calls == {"eager": 1, "capture": 1, "replay": 2}
    _assert_same_features(b, kept, "step 2 after two replays")
    _assert_same_features(c, a, "replay of step 1's images")
    _assert_same_features(d, b, "replay of step 2's images")
    assert c.uv.data_ptr() != a.uv.data_ptr() != d.uv.data_ptr()


def test_graph_two_extractors_alternate(cuda):
    """Two bfloat16 closures on the one card with different weights, called
    in turn (as a fleet's extractors are each tick): each runs eagerly,
    captures and replays, every call bit-equal to the eager `extract` with
    its own weights, and no capture packs the first pair's weights."""
    from sp_orb_slam_tpu_torch.extractor import (extract, extract_options,
                                                 make_extractor)
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg = _graph_cfg("bfloat16")
    states = [load_checkpoint(WEIGHTS)]
    states.append({k: v * 0.97 if k == "conv1b.weight" else v
                   for k, v in states[0].items()})
    runs = [make_extractor(cfg, s, device=cuda) for s in states]
    batches = [_host_images(8, seed=20 + s) for s in range(3)]
    got = [[], []]
    for x in batches:                        # eager, capture, replay
        for i, run in enumerate(runs):
            n = cuda_pair1.packs
            got[i].append(run(x))
            if len(got[i]) > 1:
                assert cuda_pair1.packs == n, f"closure {i} packed again"
    for run in runs:
        assert run.calls == {"eager": 1, "capture": 1, "replay": 1}
    for i, s in enumerate(states):
        model = SuperPoint(s).to(cuda).eval()
        with torch.inference_mode():
            want = [extract(model, torch.as_tensor(x, device=cuda),
                            **extract_options(cfg)) for x in batches]
        torch.cuda.synchronize()
        for j, (g, w) in enumerate(zip(got[i], want)):
            _assert_same_features(g, w, f"closure {i}, call {j}")
    assert not torch.equal(got[0][2].desc, got[1][2].desc)


def test_graph_cache_keys_and_eviction(cuda):
    """A new shape runs eagerly, then captures, then replays; the closure
    keeps GRAPHS_KEPT keys and the least recently used goes first, its
    graph and pinned staging buffer freed, so its shape runs eagerly
    again."""
    import gc
    import weakref

    from sp_orb_slam_tpu_torch import extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint
    from sp_orb_slam_tpu_torch.utils.graphs import GRAPHS_KEPT

    run = extractor.make_extractor(_graph_cfg("float32"),
                                   load_checkpoint(WEIGHTS), device=cuda)
    n = GRAPHS_KEPT
    shapes = [(b, 64, 96) for b in range(1, n + 2)]
    x = {s: _host_images(s[0], s[1], s[2], seed=s[0]) for s in shapes}
    first = shapes[0]
    modes = []
    for s in [first] * 3:
        before = dict(run.calls)
        run(x[s])
        modes += [k for k in run.calls if run.calls[k] != before.get(k, 0)]
    assert modes == ["eager", "capture", "replay"]
    keys = {k[0]: k for k in run.graphs}
    assert list(keys) == [first]
    graph = weakref.ref(run.graphs[keys[first]].graph)
    staging = weakref.ref(run.graphs[keys[first]].staging[0].host)
    assert staging().is_pinned()
    for s in shapes[1:]:                     # n more shapes: first goes
        run(x[s])
    assert [k[0] for k in run.graphs] == shapes[1:]
    gc.collect()
    assert graph() is None and staging() is None
    run(x[first])
    assert run.calls == {"eager": n + 2, "capture": 1, "replay": 1}
    assert [k[0] for k in run.graphs] == shapes[2:] + [first]


def test_graph_launch_counts(cuda):
    """`_build.LAUNCHES` after k replays equals k eager calls; the capture
    call counts one extraction."""
    from sp_orb_slam_tpu_torch.extractor import (extract, extract_options,
                                                 make_extractor)
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg = _graph_cfg("bfloat16")
    state = load_checkpoint(WEIGHTS)
    run = make_extractor(cfg, state, device=cuda)
    x = _host_images(2)

    def counted(fn, k):
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        return {n: c for n, c in _build.LAUNCHES.items() if c}

    assert counted(lambda: run(x), 2) == {"pair1": 2, "nms": 2, "cov": 2,
                                         "desc_sparse": 2}
    replays = counted(lambda: run(x), 3)
    assert run.calls == {"eager": 1, "capture": 1, "replay": 3}
    model = SuperPoint(state).to(cuda).eval()
    with torch.inference_mode():
        eager = counted(lambda: extract(model, torch.as_tensor(x, device=cuda),
                                        **extract_options(cfg)), 3)
    assert replays == eager == {"pair1": 3, "nms": 3, "cov": 3,
                                "desc_sparse": 3}


def _profiled(fn):
    """(host events, device events) of fn() under torch.profiler, each
    [name, start_ns, end_ns]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = [e.name(), e.start_ns(), e.start_ns() + e.duration_ns()]
        (device if e.device_type() == DeviceType.CUDA else host).append(row)
    return host, device


def _inside(host, span):
    iv = [(s, e) for n, s, e in host if n == span]
    return [n for n, s, _ in host if any(a <= s < b for a, b in iv)]


@pytest.mark.parametrize("source", ["host", "device"])
def test_graph_replay_syncs_and_device_events(cuda, source):
    """A replay waits for the card nowhere, for a host batch too (staged
    through pinned memory and copied asynchronously), where a warm eager
    call's upload of a host batch waits once; it launches the graph once,
    and the profiler sees each kernel of a warm eager call as its own
    device event."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg, state = _graph_cfg("float32"), load_checkpoint(WEIGHTS)
    run = make_extractor(cfg, state, device=cuda)
    x = _host_images(1)
    if source == "device":
        x = torch.as_tensor(x, device=cuda)
    eager = make_extractor(cfg, state, device=cuda)
    eager(x)                          # the first call casts the weights
    eager.graphs.clear()              # so that the next call is eager too
    host_e, dev_e = _profiled(lambda: eager(x))
    assert eager.calls == {"eager": 2}
    run(x)                                            # eager
    run(x)                                            # capture
    host_r, dev_r = _profiled(lambda: run(x))         # replay
    assert run.calls == {"eager": 1, "capture": 1, "replay": 1}
    in_extract = _inside(host_r, "sp/extract")
    syncs = [n for n in in_extract if n in SYNCS]
    assert syncs == []
    in_upload = _inside(host_r, "sp/extract/upload")
    assert ("sp/extract/upload/stage" in in_upload) == (source == "host")
    assert run.uploads == ({"staged": 2} if source == "host"
                           else {"direct": 2})
    assert in_extract.count("cudaGraphLaunch") == 1
    assert "sp/extract/replay" in in_extract
    eager_syncs = [n for n in _inside(host_e, "sp/extract") if n in SYNCS]
    # the eager upload's sync alone: the forward's and the selection's are gone
    assert len(eager_syncs) == (1 if source == "host" else 0)
    kernels = collections.Counter(
        n for n, _, _ in dev_e if not n.startswith("Memcpy"))
    replayed = collections.Counter(n for n, _, _ in dev_r)
    missing = {n: c for n, c in kernels.items() if replayed[n] < c}
    assert len(kernels) > 50 and not missing, missing


def _eager_features(cfg, state, batches, cuda):
    from sp_orb_slam_tpu_torch.extractor import extract, extract_options
    from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint

    model = SuperPoint(state).to(cuda).eval()
    with torch.inference_mode():
        want = [extract(model, torch.as_tensor(x, device=cuda),
                        **extract_options(cfg)) for x in batches]
    torch.cuda.synchronize()
    return want


def test_graph_staging_buffer_guarded(cuda):
    """Two replays handed in back to back on different host batches,
    neither read before both are in, while the card is held busy: the
    second staging copy finds the first batch's copy to the card not yet
    run, waits for it ("waited"), and each call returns the features of
    its own batch."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg, state = _graph_cfg("float32"), load_checkpoint(WEIGHTS)
    run = make_extractor(cfg, state, device=cuda)
    batches = [_host_images(2, seed=30 + s) for s in range(4)]
    run(batches[0])                                   # eager
    run(batches[1])                                   # capture
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)    # holds the stream for ~0.3 s
    got = [run(batches[2]), run(batches[3])]
    torch.cuda.synchronize()
    assert run.calls == {"eager": 1, "capture": 1, "replay": 2}
    assert run.uploads == {"staged": 3, "waited": 1}
    want = _eager_features(cfg, state, batches[2:], cuda)
    assert not torch.equal(want[0].uv, want[1].uv)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_features(g, w, f"replay {i}")


def test_graph_direct_uploads(cuda):
    """A batch already on the card and one in pinned host memory reach the
    graph's static input as they are ("direct"), with no pinned buffer
    allocated; a pageable host batch into the same graph is then staged.
    Every call bit-equal to the eager `extract`."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    cfg, state = _graph_cfg("bfloat16"), load_checkpoint(WEIGHTS)
    run = make_extractor(cfg, state, device=cuda)
    batches = [_host_images(4, seed=40 + s) for s in range(5)]
    xs = [torch.as_tensor(x, device=cuda) for x in batches[:3]]
    xs += [torch.as_tensor(batches[3]).pin_memory(), batches[4]]
    got = [run(xs[0]), run(xs[1]), run(xs[2])]        # eager, capture, replay
    assert run.uploads == {"direct": 2}
    (g,) = run.graphs.values()
    assert g.staging == [None]
    got.append(run(xs[3]))                            # pinned host batch
    assert run.uploads == {"direct": 3} and g.staging == [None]
    got.append(run(xs[4]))                            # pageable host batch
    assert run.uploads == {"direct": 3, "staged": 1}
    assert g.staging[0].host.is_pinned()
    torch.cuda.synchronize()
    assert run.calls == {"eager": 1, "capture": 1, "replay": 3}
    want = _eager_features(cfg, state, batches, cuda)
    for i, (a, w) in enumerate(zip(got, want)):
        _assert_same_features(a, w, f"call {i}")


def test_graph_closed_loop_never_waits(cuda):
    """The benchmark's closed loop, two batches in flight, each collected
    (read back to the host) after the next is handed in: every replay is
    staged and none waits on the staging buffer."""
    from sp_orb_slam_tpu_torch.extractor import make_extractor
    from sp_orb_slam_tpu_torch.models.weights import load_checkpoint

    run = make_extractor(_graph_cfg("bfloat16"), load_checkpoint(WEIGHTS),
                         device=cuda)
    batches = [_host_images(32, seed=50 + s) for s in range(3)]
    pending, counts = collections.deque(), []
    for k in range(10):
        pending.append(run(batches[k % 3]))
        if len(pending) >= 2:
            counts.append(pending.popleft().count.cpu())
    counts += [f.count.cpu() for f in pending]
    assert run.calls == {"eager": 1, "capture": 1, "replay": 8}
    assert run.uploads == {"staged": 9}
    assert all(torch.equal(counts[k], counts[k % 3]) for k in range(10))
