"""Port parity of the two-view initialization: sp_orb_slam_tpu_torch's
`initialize` against the JAX package's on matched pairs from the synthetic
scene, with the JAX package's own RANSAC draws handed to the port, on the
CPU.

`ok`, `used_h` and the `triangulated` mask must be equal; R21, t21 and the
points within 1e-4 (the models come from SVD null vectors whose sign the
two libraries may choose differently; the selected motion does not depend
on it).  A homography scene (a plane) exercises ReconstructH, a general
scene ReconstructF."""

import jax
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.geometry import twoview as jtv
from sp_orb_slam_tpu_torch.geometry import twoview as ttv

torch.set_num_threads(2)

TOL = 1e-4
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
ITERS = 60


def _pairs(seed, planar: bool, n=200, noise=0.5, outliers=0.1):
    rng = np.random.default_rng(seed)
    if planar:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      np.full(n, 6.0)], -1)
    else:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(3, 12, n)], -1)
    c, s = np.cos(0.08), np.sin(0.08)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    t = np.array([-1.2 if planar else -0.6, 0.05, 0.1])

    def proj(P):
        return np.stack([K[0] * P[:, 0] / P[:, 2] + K[2],
                         K[1] * P[:, 1] / P[:, 2] + K[3]], -1)

    uv1 = proj(X) + rng.normal(0, noise, (n, 2))
    uv2 = proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    Kc = 256
    pad = np.zeros((Kc, 2), np.float32)
    u1, u2 = pad.copy(), pad.copy()
    u1[:n], u2[:n] = uv1, uv2
    valid = np.zeros(Kc, bool)
    valid[:n] = rng.random(n) > 0.05    # some unmatched slots
    return u1, u2, valid


@pytest.mark.parametrize("seed,planar", [(1, False), (2, False), (3, True)])
def test_initialize_matches_jax(seed, planar):
    uv1, uv2, valid = _pairs(seed, planar)
    key = jax.random.PRNGKey(seed)
    draws = np.array(jax.random.randint(key, (ITERS, 8), 0,
                                          max(int(valid.sum()), 1)))
    want = jtv.initialize(uv1, uv2, valid, K, key, iters=ITERS)
    got = ttv.initialize(torch.from_numpy(uv1), torch.from_numpy(uv2),
                         torch.from_numpy(valid), torch.from_numpy(K),
                         torch.from_numpy(draws))
    assert bool(got.ok) == bool(want.ok)
    assert bool(got.used_h) == bool(want.used_h)
    assert bool(got.used_h) == planar
    assert bool(want.ok)
    np.testing.assert_array_equal(got.triangulated.numpy(),
                                  np.asarray(want.triangulated))
    for a, b in ((got.R21, want.R21), (got.t21, want.t21)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=0)
    tri = np.asarray(want.triangulated)
    np.testing.assert_allclose(got.points.numpy()[tri],
                               np.asarray(want.points)[tri], atol=TOL,
                               rtol=TOL)


def test_initialize_rejects_too_few_matches():
    uv1, uv2, valid = _pairs(4, False)
    valid[7:] = False
    got = ttv.initialize(torch.from_numpy(uv1), torch.from_numpy(uv2),
                         torch.from_numpy(valid), torch.from_numpy(K),
                         torch.zeros((ITERS, 8), dtype=torch.long))
    assert not bool(got.ok)


def test_draws_reduce_modulo_the_valid_count():
    """Raw generator integers and their residues give the same result."""
    uv1, uv2, valid = _pairs(5, False)
    n = int(valid.sum())
    raw = torch.randint(0, 2 ** 30, (ITERS, 8),
                        generator=torch.Generator().manual_seed(0))
    args = [torch.from_numpy(a) for a in (uv1, uv2, valid, K)]
    a = ttv.initialize(*args, raw)
    b = ttv.initialize(*args, raw % n)
    assert torch.equal(a.R21, b.R21) and torch.equal(a.points, b.points)
