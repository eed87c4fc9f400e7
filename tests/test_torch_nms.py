"""Port parity: grid NMS and keypoint selection (sp_orb_slam_tpu_torch/ops/
nms.py, the plain version behind ops/cuda_nms.py) against the JAX package's
Pallas kernel `batched_grid_nms` (interpret mode), its XLA fixed point and
the sequential golden model, on the CPU.  Index outputs are exact, with
forced score ties."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_orb_slam_tpu.ops import nms as jnms
from sp_orb_slam_tpu.ops import pallas_nms
from sp_orb_slam_tpu_torch.ops import cuda_nms
from sp_orb_slam_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)


def _cells(rng, B, hc, wc, p_valid, ties=True):
    score = rng.random((B, hc, wc)).astype(np.float32)
    if ties:
        score = np.round(score * 50) / 50  # force exact-score ties
    u = (np.arange(wc)[None, None, :] * 8
         + rng.integers(0, 8, (B, hc, wc))).astype(np.int32)
    v = (np.arange(hc)[None, :, None] * 8
         + rng.integers(0, 8, (B, hc, wc))).astype(np.int32)
    valid = rng.random((B, hc, wc)) < p_valid
    return score.astype(np.float32), np.stack([u, v], -1), valid


def test_nms_matches_pallas_and_golden():
    rng = np.random.default_rng(7)
    score, uv, valid = _cells(rng, 2, 60, 94, 0.5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_nms.batched_grid_nms(
            jnp.asarray(score), jnp.asarray(uv), jnp.asarray(valid),
            dist=4, iters=16))
    # a CPU tensor takes the plain fixed point
    got = cuda_nms.batched_grid_nms(torch.from_numpy(score),
                                    torch.from_numpy(uv),
                                    torch.from_numpy(valid), dist=4,
                                    iters=16).numpy()
    gold = np.stack([tnms.greedy_grid_nms_reference(
        score[b], uv[b], valid[b], dist=4) for b in range(2)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gold)


@pytest.mark.parametrize("iters", [1, 3, 32])
def test_nms_matches_xla_fixed_point(iters):
    """Exact also before convergence: the same Jacobi rounds."""
    rng = np.random.default_rng(iters)
    score, uv, valid = _cells(rng, 2, 15, 20, 0.8)
    want = np.asarray(jax.vmap(partial(jnms.greedy_grid_nms, dist=4,
                                       iters=iters))(
        jnp.asarray(score), jnp.asarray(uv), jnp.asarray(valid)))
    got = tnms.greedy_grid_nms(torch.from_numpy(score), torch.from_numpy(uv),
                               torch.from_numpy(valid), dist=4,
                               iters=iters).numpy()
    np.testing.assert_array_equal(got, want)


def test_golden_models_agree():
    rng = np.random.default_rng(9)
    score, uv, valid = _cells(rng, 1, 15, 20, 0.6)
    np.testing.assert_array_equal(
        tnms.greedy_grid_nms_reference(score[0], uv[0], valid[0]),
        jnms.greedy_grid_nms_reference(score[0], uv[0], valid[0]))


@pytest.mark.parametrize("case", [
    # (hc, wc, num_features, K, p_valid): cap binding, cap loose, and a
    # tiny grid with fewer cells than slots
    (15, 20, 50, 64, 0.8),
    (15, 20, 200, 256, 0.5),
    (4, 5, 8, 32, 0.9),
])
def test_select_keypoints_matches_jax(case):
    hc, wc, nf, K, p = case
    rng = np.random.default_rng(hc * wc + nf)
    score, uv, valid = _cells(rng, 3, hc, wc, p)
    h, w = hc * 8, wc * 8
    kw = dict(num_features=nf, max_keypoints=K, image_hw=(h, w),
              nms_iters=16)
    want = jax.vmap(lambda s, c, v: jnms.select_keypoints(s, c, v, **kw))(
        jnp.asarray(score), jnp.asarray(uv), jnp.asarray(valid))
    got = tnms.select_keypoints(torch.from_numpy(score),
                                torch.from_numpy(uv),
                                torch.from_numpy(valid), **kw)
    assert got._fields == want._fields
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, f
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)


def _chain(B, hc, wc):
    """A monotone score ramp along a zigzag path of conflicting cells: row
    0 at (8c + 3, 7), row 1 at (8c + 7, 8), so (0, c) conflicts with (1, c)
    and (1, c) with (0, c + 1) and no other pair; the path's 2 wc cells
    decide one a round, so the fixed point needs 2 wc Jacobi rounds.  Rows
    below 1 are invalid."""
    k = np.arange(2 * wc)
    r, c = k % 2, k // 2
    score = np.zeros((B, hc, wc), np.float32)
    uv = np.zeros((B, hc, wc, 2), np.int32)
    valid = np.zeros((B, hc, wc), bool)
    score[:, r, c] = 1.0 - k / (4.0 * wc)
    uv[:, r, c, 0] = 8 * c + 3 + 4 * r
    uv[:, r, c, 1] = 7 + r
    valid[:, r, c] = True
    return score, uv, valid


def test_nms_long_chain_stops_at_iters():
    """A chain that needs 48 rounds: after 16 the plain fixed point equals
    the Pallas kernel (interpret mode) and the XLA fixed point, and differs
    from the converged golden; after 64 it equals the golden."""
    score, uv, valid = _chain(2, 3, 24)
    args = [torch.from_numpy(x) for x in (score, uv, valid)]
    # one cell decided a round, kept and rejected in turn: the last kept
    # at round 47, the last rejected at round 48
    assert [int(tnms.greedy_grid_nms(*args, dist=4, iters=k)[0].sum())
            for k in (16, 46, 47, 48)] == [8, 23, 24, 24]
    gold = np.stack([tnms.greedy_grid_nms_reference(
        score[b], uv[b], valid[b], dist=4) for b in range(2)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_nms.batched_grid_nms(
            jnp.asarray(score), jnp.asarray(uv), jnp.asarray(valid),
            dist=4, iters=16))
    xla = np.asarray(jax.vmap(partial(jnms.greedy_grid_nms, dist=4,
                                      iters=16))(
        jnp.asarray(score), jnp.asarray(uv), jnp.asarray(valid)))
    got = cuda_nms.batched_grid_nms(*args, dist=4, iters=16).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, xla)
    assert got.sum() == 2 * 8 and (got != gold).any()
    np.testing.assert_array_equal(
        tnms.greedy_grid_nms(*args, dist=4, iters=64).numpy(), gold)


H100_SMEM_OPTIN = 232448  # shared memory a block can opt in to on Hopper


def test_nms_footprint():
    """The kernel's per-image grid: 180 words and 98,144 B at 752x480;
    1241x376 (155 columns, not a multiple of 32) fits; 1080p does not."""
    assert cuda_nms.footprint(60, 94) == (180, 98144)
    words, smem = cuda_nms.footprint(47, 155)
    assert words == 235 and smem <= H100_SMEM_OPTIN
    words, smem = cuda_nms.footprint(135, 240)
    assert words > cuda_nms.MAX_WORDS or smem > H100_SMEM_OPTIN


def test_nms_cluster_size():
    """8 blocks an image up to B=8 on the H100's 132 SMs, 1 above."""
    assert [cuda_nms.cluster_size(b, 132) for b in (1, 8, 9, 32, 220)] == [
        8, 8, 1, 1, 1]


def _at_gather(x, i):
    """`_at` as it was: the index uploaded, clamped, then gathered."""
    i = torch.as_tensor(i, device=x.device).clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, i.reshape(-1, 1).expand(x.shape[0], 1))[:, 0]


@pytest.mark.parametrize("i", [0, 5, 11, -1, -7, 12, 40])
def test_at_is_the_clamped_gather(i):
    """The basic index equals the clamped gather in range, below it and past
    its end."""
    x = torch.from_numpy(np.random.default_rng(3).random((3, 12), np.float32))
    np.testing.assert_array_equal(tnms._at(x, i).numpy(),
                                  _at_gather(x, i).numpy())
