"""The port's optim/sim3.py against the JAX package's, on the CPU.

The same numpy inputs go through both; the RANSAC takes JAX's own draws
(`jax.random.randint` over the key the JAX function splits), so the
hypotheses are the same.  Tolerances: the group operations 1e-5, Horn's
closed form and the RANSAC winner 1e-4 (an SVD in float32), the LM solves
1e-3 (OptimizeSim3 and the pose graph: 15-25 damped float32 solves, whose
rounding differs between LAPACK builds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.optim import sim3 as js3
from sp_orb_slam_tpu_torch.optim import sim3 as ts3

K_INTR = np.array([260.0, 260.0, 160.0, 120.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tangents(rng, n):
    xi = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    xi[0] = 0.0                      # identity
    xi[1, :3] = 1e-7                 # small angle
    xi[2, 6] = 1e-7                  # small scale
    xi[3, :3], xi[3, 6] = 1e-7, 1e-7  # both small
    return xi


def test_exp_log_mul_inverse_match_jax(rng):
    xi = _tangents(rng, 32)
    jR, jt, js = (np.asarray(a) for a in js3.sim3_exp_batch(jnp.asarray(xi)))
    tR, tt, ts = (a.numpy() for a in ts3.sim3_exp(_t(xi)))
    for j, t in ((jR, tR), (jt, tt), (js, ts)):
        np.testing.assert_allclose(t, j, atol=1e-5)
    jl = np.asarray(js3.sim3_log_batch(jnp.asarray(jR), jnp.asarray(jt),
                                       jnp.asarray(js)))
    tl = ts3.sim3_log(_t(jR), _t(jt), _t(js)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    np.testing.assert_allclose(tl, xi, atol=1e-4)  # the round trip
    A = (jR[:16], jt[:16], js[:16])
    B = (jR[16:], jt[16:], js[16:])
    jm = [np.asarray(a) for a in jax.vmap(js3.sim3_mul)(
        tuple(map(jnp.asarray, A)), tuple(map(jnp.asarray, B)))]
    tm = [a.numpy() for a in ts3.sim3_mul(tuple(map(_t, A)),
                                          tuple(map(_t, B)))]
    ji = [np.asarray(a) for a in jax.vmap(js3.sim3_inverse)(
        tuple(map(jnp.asarray, A)))]
    ti = [a.numpy() for a in ts3.sim3_inverse(tuple(map(_t, A)))]
    for j, t in zip(jm + ji, tm + ti):
        np.testing.assert_allclose(t, j, atol=1e-5)


def _sim3_scene(rng, n, n_valid, outliers):
    """Camera-frame points of two views related by a known Sim3 S21, their
    pixels with 0.5 px noise, and `outliers` corrupted pairs."""
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], -1).astype(np.float32)
    R = js3.sim3_exp(jnp.asarray([0.05, -0.1, 0.08, 0.3, -0.2, 0.1,
                                  np.log(1.3)], jnp.float32))
    R, t, s = (np.asarray(a, np.float64) for a in R)
    X2 = (s * X1 @ R.T + t).astype(np.float32)

    def proj(X):
        return np.stack([K_INTR[0] * X[:, 0] / X[:, 2] + K_INTR[2],
                         K_INTR[1] * X[:, 1] / X[:, 2] + K_INTR[3]], -1)

    uv1 = (proj(X1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(X2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    X2[:outliers] += rng.normal(0, 1.0, (outliers, 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    return X1, X2, uv1, uv2, valid, (R, t, s)


def test_horn_matches_jax(rng):
    X1, X2, _, _, _, (R, t, s) = _sim3_scene(rng, 40, 40, 0)
    X2 = X2 + rng.normal(0, 0.01, X2.shape).astype(np.float32)
    j = [np.asarray(a) for a in js3.sim3_horn(jnp.asarray(X1),
                                              jnp.asarray(X2))]
    tt = [a.numpy() for a in ts3.sim3_horn(_t(X1), _t(X2))]
    for a, b in zip(j, tt):
        np.testing.assert_allclose(b, a, atol=1e-4)
    np.testing.assert_allclose(tt[0], R, atol=1e-2)
    assert abs(float(tt[2]) - s) < 1e-2
    # a batch of 3-point samples, repeated indices among them
    idx = rng.integers(0, 40, (64, 3))
    idx[:4, 1] = idx[:4, 0]
    jb = [np.asarray(a) for a in jax.vmap(js3.sim3_horn)(
        jnp.asarray(X1[idx]), jnp.asarray(X2[idx]))]
    tb = [a.numpy() for a in ts3.sim3_horn(_t(X1[idx]), _t(X2[idx]))]
    # a repeated index leaves a rank-1 matrix, whose SVD's null vectors
    # (hence R) are arbitrary: compare the samples of 3 distinct points
    ok = ((idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2])
          & (idx[:, 0] != idx[:, 2]))
    for a, b in zip(jb, tb):
        np.testing.assert_allclose(b[ok], a[ok], atol=1e-4)
        assert np.isfinite(b).all()


def test_ransac_matches_jax_given_its_draws(rng):
    X1, X2, uv1, uv2, valid, _ = _sim3_scene(rng, 96, 70, 25)
    key = jax.random.PRNGKey(7)
    j = js3.sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(uv1),
                        jnp.asarray(uv2), jnp.asarray(valid),
                        jnp.asarray(K_INTR), key)
    draws = np.asarray(jax.random.randint(key, (300, 3), 0,
                                          max(int(valid.sum()), 1)))
    t = ts3.sim3_ransac(_t(X1), _t(X2), _t(uv1), _t(uv2),
                        torch.from_numpy(valid), _t(K_INTR),
                        torch.from_numpy(draws))
    assert bool(j.ok) and bool(t.ok)
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    for a, b in ((j.R, t.R), (j.t, t.t), (j.s, t.s)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_optimize_sim3_matches_jax(rng):
    X1, X2, uv1, uv2, valid, _ = _sim3_scene(rng, 64, 60, 10)
    key = jax.random.PRNGKey(3)
    K = jnp.asarray(K_INTR)
    r = js3.sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(uv1),
                        jnp.asarray(uv2), jnp.asarray(valid), K, key)
    R0, t0, s0 = (np.asarray(a) for a in (r.R, r.t, r.s))
    # start off the RANSAC winner so the LM has work to do
    R0 = np.asarray(js3.sim3_exp(jnp.asarray(
        [0.01, -0.01, 0.02, 0, 0, 0, 0], jnp.float32))[0]) @ R0
    w1 = rng.uniform(0.5, 1.5, (64, 2)).astype(np.float32)
    w2 = rng.uniform(0.5, 1.5, (64, 2)).astype(np.float32)
    args = (X1, X2, uv1, uv2, w1, w2)
    jR, jt, js, jin, jn = js3.optimize_sim3(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s0),
        *map(jnp.asarray, args), jnp.asarray(valid), K)
    tR, tt, ts, tin, tn = ts3.optimize_sim3(
        _t(R0), _t(t0), _t(s0), *map(_t, args), torch.from_numpy(valid),
        _t(K_INTR))
    assert int(tn) == int(jn) and int(tn) >= 40
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    for a, b in ((jR, tR), (jt, tt), (js, ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


def _ring():
    """tests/test_loop_closing.py::test_pose_graph_ring's drifted ring."""
    n = 24
    true_step = jnp.asarray(np.concatenate(
        [[0.0, 2 * np.pi / n, 0.0], [0.5, 0.0, 0.02], [0.0]]), jnp.float32)
    drift = jnp.asarray(np.concatenate(
        [[0.002, 0.0, 0.001], [0.01, 0.002, 0.0], [0.002]]), jnp.float32)
    xs = []
    S = (jnp.eye(3), jnp.zeros(3), jnp.float32(1.0))
    for _ in range(n):
        xs.append(js3.sim3_log(*S))
        step = js3.sim3_mul(js3.sim3_exp(drift), js3.sim3_exp(true_step))
        S = js3.sim3_mul(step, S)
    ei, ej, meas = list(range(n - 1)), list(range(1, n)), \
        [np.asarray(true_step)] * (n - 1)
    S_true = (jnp.eye(3), jnp.zeros(3), jnp.float32(1.0))
    rels = [S_true]
    for _ in range(n - 1):
        S_true = js3.sim3_mul(js3.sim3_exp(true_step), S_true)
        rels.append(S_true)
    Sji = js3.sim3_mul(rels[0], js3.sim3_inverse(rels[-1]))
    ei.append(n - 1)
    ej.append(0)
    meas.append(np.asarray(js3.sim3_log(*Sji)))
    fixed = np.array([True] + [False] * (n - 1))
    return (np.asarray(jnp.stack(xs)), fixed, np.asarray(ei, np.int32),
            np.asarray(ej, np.int32), np.stack(meas).astype(np.float32))


@pytest.mark.parametrize("iters", [5, 25])
def test_pose_graph_ring_matches_jax(iters):
    xi, fixed, ei, ej, meas = _ring()
    valid = np.ones(len(ei), bool)
    j = np.asarray(js3.optimize_pose_graph(
        jnp.asarray(xi), jnp.asarray(fixed), jnp.asarray(ei),
        jnp.asarray(ej), jnp.asarray(meas), jnp.asarray(valid), iters=iters))
    t = ts3.optimize_pose_graph(
        _t(xi), torch.from_numpy(fixed), torch.from_numpy(ei),
        torch.from_numpy(ej), _t(meas), torch.from_numpy(valid),
        iters=iters).numpy()
    np.testing.assert_allclose(t, j, atol=1e-3)
    np.testing.assert_array_equal(t[0], xi[0])  # the fixed node

    def cost(x):
        r = ts3._edge_residual(_t(x)[ei], _t(x)[ej], _t(meas))
        return float((r * r).sum())

    if iters == 25:  # tests/test_loop_closing.py's own gate
        assert cost(t) < 1e-2 * cost(xi), (cost(xi), cost(t))


def test_pose_graph_padding_is_inert():
    """Padded nodes (fixed, no edges) and padded edges (invalid), as the
    JAX package adds them, leave the real nodes' result unchanged: the
    port solves without them."""
    xi, fixed, ei, ej, meas = _ring()
    n, e = len(xi), len(ei)
    xip = np.concatenate([xi, np.zeros((8, 7), np.float32)])
    fixedp = np.concatenate([fixed, np.ones(8, bool)])
    eip = np.concatenate([ei, np.zeros(8, np.int32)])
    ejp = np.concatenate([ej, np.zeros(8, np.int32)])
    measp = np.concatenate([meas, np.zeros((8, 7), np.float32)])
    validp = np.arange(e + 8) < e
    a = ts3.optimize_pose_graph(
        _t(xi), torch.from_numpy(fixed), torch.from_numpy(ei),
        torch.from_numpy(ej), _t(meas), torch.ones(e, dtype=torch.bool),
        iters=10).numpy()
    b = ts3.optimize_pose_graph(
        _t(xip), torch.from_numpy(fixedp), torch.from_numpy(eip),
        torch.from_numpy(ejp), _t(measp), torch.from_numpy(validp),
        iters=10).numpy()
    np.testing.assert_allclose(b[:n], a, atol=1e-5)
