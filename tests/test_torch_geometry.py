"""Port parity of the geometry layer: se3, camera and triangulation of
sp_orb_slam_tpu_torch against the JAX package on the same seeded inputs,
on the CPU.

Tolerance atol 1e-5 (float32 with a different summation order), with these
stated exceptions: so3_log near theta = pi is not compared (both document
degraded precision there); pixel outputs of projections at ~500 px
magnitude and rectification grids are compared at rtol 1e-6 + atol 1e-4
(a few float32 ulps of the value); DLT points at 1e-4 relative (an SVD
null vector carries the conditioning of its 4x4 design matrix) and the
depth uncertainty tau at atol 1e-4 (a difference of two depths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.geometry import camera as jcam
from sp_orb_slam_tpu.geometry import se3 as jse3
from sp_orb_slam_tpu.geometry import triangulation as jtri
from sp_orb_slam_tpu_torch.geometry import camera as tcam
from sp_orb_slam_tpu_torch.geometry import se3 as tse3
from sp_orb_slam_tpu_torch.geometry import triangulation as ttri

torch.set_num_threads(2)

ATOL = 1e-5
K = np.array([458.0, 457.0, 367.0, 248.0], np.float32)
DIST = np.array([-0.2834, 0.0740, 0.0002, 1.76e-05, 0.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _xi(rng, n, rot=1.0, trans=2.0):
    xi = np.concatenate([rng.normal(0, rot, (n, 3)),
                         rng.normal(0, trans, (n, 3))], -1)
    xi[:4, :3] *= 1e-5   # the small-angle series branch
    return xi.astype(np.float32)


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "_V", "se3_exp"])
def test_se3_forward_maps(rng, fn):
    x = _xi(rng, 64)
    arg = x if fn == "se3_exp" else x[:, :3]
    want = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    got = getattr(tse3, fn)(_t(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_se3_log_inv_roundtrips(rng):
    xi = _xi(rng, 64, rot=0.6)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    for fn in ("se3_log", "se3_inv", "camera_center"):
        np.testing.assert_allclose(getattr(tse3, fn)(_t(T)).numpy(),
                                   np.asarray(getattr(jse3, fn)(
                                       jnp.asarray(T))), atol=ATOL, rtol=0)
    # round trips inside the port
    np.testing.assert_allclose(tse3.se3_log(tse3.se3_exp(_t(xi))).numpy(),
                               xi, atol=1e-4, rtol=0)
    eye = tse3.se3_inv(_t(T)) @ _t(T)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4),
                                                            eye.shape),
                               atol=ATOL, rtol=0)


def test_se3_apply_and_sim3(rng):
    T = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 1)[0])))
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    for x in (pts, pts[0]):
        np.testing.assert_allclose(tse3.se3_apply(_t(T), _t(x)).numpy(),
                                   np.asarray(jse3.se3_apply(
                                       jnp.asarray(T), jnp.asarray(x))),
                                   atol=1e-4, rtol=0)
    R = T[:3, :3]
    t = rng.normal(size=3).astype(np.float32)
    s = np.float32(1.7)
    np.testing.assert_allclose(
        tse3.sim3_matrix(_t(R), _t(t), _t(s)).numpy(),
        np.asarray(jse3.sim3_matrix(jnp.asarray(R), jnp.asarray(t),
                                    jnp.asarray(s))), atol=ATOL, rtol=0)
    for a, b in zip(tse3.sim3_inv(_t(R), _t(t), _t(s)),
                    jse3.sim3_inv(jnp.asarray(R), jnp.asarray(t),
                                  jnp.asarray(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(
        tse3.sim3_apply(_t(R), _t(t), _t(s), _t(pts)).numpy(),
        np.asarray(jse3.sim3_apply(jnp.asarray(R), jnp.asarray(t),
                                   jnp.asarray(s), jnp.asarray(pts))),
        atol=1e-4, rtol=0)


def test_camera_project_and_frustum(rng):
    pc = np.concatenate([rng.normal(0, 2, (60, 2)),
                         rng.uniform(0.5, 10, (60, 1))], -1).astype(np.float32)
    uv_t, z_t = tcam.project(_t(K), _t(pc))
    uv_j, z_j = jcam.project(jnp.asarray(K), jnp.asarray(pc))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(
        tcam.back_project(_t(K), uv_t).numpy(),
        np.asarray(jcam.back_project(jnp.asarray(K), uv_j)), atol=ATOL)
    T = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 1, rot=0.2)[0])))
    normals = rng.normal(size=(60, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    bounds = np.array([0, 751, 0, 479], np.float32)
    dmin = np.full(60, 0.5, np.float32)
    dmax = np.full(60, 8.0, np.float32)
    got = tcam.in_frustum(_t(T), _t(K), _t(pc), _t(bounds), _t(normals),
                          _t(dmin), _t(dmax), 0.5)
    want = jcam.in_frustum(jnp.asarray(T), jnp.asarray(K), jnp.asarray(pc),
                           jnp.asarray(bounds), jnp.asarray(normals),
                           jnp.asarray(dmin), jnp.asarray(dmax), 0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-4)


def test_camera_rectify_and_remap(rng):
    Hh, Ww = 48, 64
    Kn = np.array([50.0, 50.0, 32.0, 24.0], np.float32)
    grid_t = tcam.rectify_map(_t(Kn), _t(Kn), _t(DIST), Hh, Ww)
    grid_j = jcam.rectify_map(jnp.asarray(Kn), jnp.asarray(Kn),
                              jnp.asarray(DIST), Hh, Ww)
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j),
                               rtol=1e-6, atol=1e-4)
    img = rng.random((Hh, Ww)).astype(np.float32)
    out_t = tcam.bilinear_remap(_t(img), grid_t).numpy()
    out_j = np.asarray(jcam.bilinear_remap(jnp.asarray(img), grid_j))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_camera_undistort_points(rng):
    uv = np.stack([rng.uniform(0, 752, 100), rng.uniform(0, 480, 100)],
                  -1).astype(np.float32)
    got = tcam.undistort_points(_t(uv), _t(K), _t(DIST)).numpy()
    want = np.asarray(jcam.undistort_points(jnp.asarray(uv), jnp.asarray(K),
                                            jnp.asarray(DIST)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _two_views(rng, n=80):
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                        rng.uniform(3, 8, (n, 1))], -1).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.02, -0.05, 0.01, -0.4, 0.05, 0.1], np.float32))))
    uv1 = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(X))[0])
    uv2 = np.asarray(jcam.project(jnp.asarray(K), jnp.asarray(
        X @ T2[:3, :3].T + T2[:3, 3]))[0])
    uv1 = uv1 + rng.normal(0, 0.5, uv1.shape).astype(np.float32)
    uv2 = uv2 + rng.normal(0, 0.5, uv2.shape).astype(np.float32)
    return X, T1, T2, uv1, uv2


def test_triangulate_and_gates(rng):
    X, T1, T2, uv1, uv2 = _two_views(rng)

    def norm(uv):
        return np.stack([(uv[:, 0] - K[2]) / K[0],
                         (uv[:, 1] - K[3]) / K[1]], -1).astype(np.float32)

    Xj = np.asarray(jtri.triangulate(jnp.asarray(T1[:3]), jnp.asarray(T2[:3]),
                                     jnp.asarray(norm(uv1)),
                                     jnp.asarray(norm(uv2))))
    Xt = ttri.triangulate(_t(T1[:3]), _t(T2[:3]), _t(norm(uv1)),
                          _t(norm(uv2))).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-5)
    assert np.abs(Xt - X).max() < 0.5  # and near the truth

    cov = rng.uniform(0.5, 2.0, (len(X), 2)).astype(np.float32)
    valid = rng.random(len(X)) > 0.1
    gj = jtri.triangulation_gates(jnp.asarray(Xj), jnp.asarray(T1),
                                  jnp.asarray(T2), jnp.asarray(K),
                                  jnp.asarray(uv1), jnp.asarray(uv2),
                                  jnp.asarray(cov), jnp.asarray(cov),
                                  jnp.asarray(valid))
    gt = ttri.triangulation_gates(_t(Xj), _t(T1), _t(T2), _t(K), _t(uv1),
                                  _t(uv2), _t(cov), _t(cov), _t(valid))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert gt.good.any() and not gt.good.all()

    O1 = np.zeros(3, np.float32)
    O2 = np.asarray(jse3.camera_center(jnp.asarray(T2)))
    ang = 2.0 * np.arctan(1.0 / (2.0 * K[0]))
    zj, tj = jtri.depth_and_tau(jnp.asarray(Xj), jnp.asarray(O1),
                                jnp.asarray(O2), ang)
    zt, tt = ttri.depth_and_tau(_t(Xj), _t(O1), _t(O2), ang)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)
    # tau = |z_plus - z| through arccos near 1: a difference of two
    # z-sized (~5) quantities, so float32 leaves ~1e-5 absolute noise
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-3,
                               atol=1e-4)
