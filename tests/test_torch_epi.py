"""The epipolar-walk triangulation matcher of the port (matching_method=2:
SearchForTriByEpi, sp_matcher.cpp:24-181, dispatched at
local_mapper.cpp:623-631) against the JAX package, on the CPU:

(a) `search_for_tri_by_epi` on the scenarios of tests/test_matchers.py (true
    pairs recovered; candidates pushed off the epipolar line rejected) and
    with some features taken and a covariance per keypoint: match21
    exactly equal to JAX's;
(b) `triangulate_body` with method 2 on synthetic keyframes: the match
    indices and gates equal, points and depths within 1e-4 (the existing
    triangulation test's tolerance), and the TrackingKernels stage counts
    its method-2 rows;
(c) the synthetic rail with matching_method=2 through both Systems, the
    port taking the JAX init draws: 0 LOST, the port's ATE within 0.02 of
    JAX's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.dataset import SyntheticDataset as JSynthetic
from sp_orb_slam_tpu.ops import matching as jm
from sp_orb_slam_tpu.slam import kernels as jk
from sp_orb_slam_tpu.slam import tracking as jtr
from sp_orb_slam_tpu.slam.system import System as JSystem
from sp_orb_slam_tpu_torch.config import Config, _merge_dataclass
from sp_orb_slam_tpu_torch.io.dataset import SyntheticDataset
from sp_orb_slam_tpu_torch.ops import matching as tm
from sp_orb_slam_tpu_torch.slam import kernels as tk
from sp_orb_slam_tpu_torch.slam import tracking as ttr
from sp_orb_slam_tpu_torch.slam.system import System
from test_matchers import _fundamental, _lookat_cams, _project
from test_torch_slam_kernels import (CFG, K_INTR, _frame, _j, _t, _tcw,
                                     scene)  # noqa: F401 (fixture)
from test_torch_system import SMALL, JaxInitDraws, _ate

torch.set_num_threads(2)

TOL = 1e-4
K = np.array([300.0, 300.0, 320.0, 240.0], np.float32)
EPI = {**SMALL, "mapping": {"matching_method": 2}}


def _pair(rng, N, spread, off=0.0):
    """tests/test_matchers.py's two cameras: N points, their projections
    (the second image's pushed `off` px down), unit descriptors, F12, R21
    and the epipole."""
    Km = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]], np.float32)
    T1, T2 = _lookat_cams()
    X = np.stack([rng.uniform(-spread[0], spread[0], N),
                  rng.uniform(-spread[1], spread[1], N),
                  rng.uniform(*spread[2], N)], -1).astype(np.float32)
    uv1, _ = _project(T1, X, K)
    uv2, _ = _project(T2, X, K)
    uv2 = (uv2 + np.array([0.0, off], np.float32)).astype(np.float32)
    desc = rng.normal(size=(N, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    F12 = _fundamental(T1, T2, Km).astype(np.float32)
    R21 = (T2[:3, :3] @ T1[:3, :3].T).astype(np.float32)
    C1_in_2 = T2[:3, :3] @ (-T1[:3, :3].T @ T1[:3, 3]) + T2[:3, 3]
    e2 = np.array([K[0] * C1_in_2[0] / C1_in_2[2] + K[2],
                   K[1] * C1_in_2[1] / C1_in_2[2] + K[3]], np.float32)
    return uv1.astype(np.float32), uv2, desc, F12, R21, e2


def _both(desc1, uv1, free1, desc2, uv2, free2, e2, F12, R21, cov):
    args = (desc1, uv1, free1, desc2, uv2, free2, e2, F12, R21, K, cov)
    want = np.asarray(jm.search_for_tri_by_epi(*map(jnp.asarray, args)))
    got = tm.search_for_tri_by_epi(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_epi_recovers_true_pairs_as_jax(rng):
    N = 64
    uv1, uv2, desc, F12, R21, e2 = _pair(rng, N, (3, 2, (4, 8)))
    inb = (((uv1 > 20) & (uv1 < [620, 460])).all(-1)
           & ((uv2 > 20) & (uv2 < [620, 460])).all(-1))
    m21 = _both(desc, uv1, inb, desc, uv2, inb, e2, F12, R21,
                np.ones((N, 2), np.float32))
    got = {(int(m), j) for j, m in enumerate(m21) if m >= 0}
    expect = {(i, i) for i in range(N)
              if inb[i] and (uv2[i] - e2) @ (uv2[i] - e2) >= 100.0}
    assert got <= {(i, i) for i in range(N)}
    assert len(got & expect) >= 0.9 * max(len(expect), 1)


def test_epi_rejects_off_line_as_jax(rng):
    N = 8
    uv1, uv2, desc, F12, R21, e2 = _pair(rng, N, (1, 1, (4, 6)), off=60.0)
    ones = np.ones(N, bool)
    m21 = _both(desc, uv1, ones, desc, uv2, ones, e2, F12, R21,
                np.ones((N, 2), np.float32))
    assert (m21 < 0).all(), m21


def test_epi_with_taken_features_and_covariance(rng):
    """Some features of either keyframe already bound, noisy descriptors
    and a covariance per keypoint: the band, the gates and the uniqueness
    decide the same pairs."""
    N = 128
    uv1, uv2, desc, F12, R21, e2 = _pair(rng, N, (3, 2, (3, 9)))
    uv2 = (uv2 + rng.normal(0, 0.7, uv2.shape)).astype(np.float32)
    desc2 = desc + rng.normal(0, 0.03, desc.shape).astype(np.float32)
    desc2 /= np.linalg.norm(desc2, axis=-1, keepdims=True)
    free1 = rng.random(N) > 0.2
    free2 = rng.random(N) > 0.2
    cov = rng.uniform(0.3, 3.0, (N, 2)).astype(np.float32)
    m21 = _both(desc, uv1, free1, desc2, uv2, free2, e2, F12, R21, cov)
    assert (m21 >= 0).sum() > 30


def test_triangulate_body_method2_matches_jax(scene):
    f1, f2 = _frame(scene, 6), _frame(scene, 3)
    T1, T2 = _tcw(scene, 6), _tcw(scene, 3)
    rng = np.random.default_rng(0)
    free1 = f1["valid"] & (rng.random(256) > 0.3)
    free2 = f2["valid"] & (rng.random(256) > 0.3)
    args = (T1, T2, f1["uv"], f1["desc"], f1["cov"], free1, f2["uv"],
            f2["desc"], f2["cov"], free2)
    want = jk.triangulate_body(*map(_j, args), _j(K_INTR), nn_ratio=0.7,
                               method=2)
    got = tk.triangulate_body(*map(_t, args), _t(K_INTR), nn_ratio=0.7,
                              method=2)
    for k in ("match21", "good", "n_good"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    good = np.asarray(want["good"])
    assert good.sum() > 30
    for k in ("points", "z1", "z2"):
        np.testing.assert_allclose(got[k].numpy()[good],
                                   np.asarray(want[k])[good], rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the host-facing stage dispatches method 2 and counts its rows
    kern = tk.TrackingKernels(
        _merge_dataclass(CFG, {"mapping": {"matching_method": 2}}),
        device="cpu")
    out = kern.triangulate_pair_batch([args, args])
    assert kern.tri_rows == {2: 2}
    np.testing.assert_array_equal(out[1]["match21"], np.asarray(
        want["match21"]))


def test_epi_rail_matches_jax():
    jcfg, cfg = jmerge(JConfig(), EPI), _merge_dataclass(Config(), EPI)
    kw = dict(n_frames=50, n_points=5000, seed=6, pixel_noise=0.3)
    jsys = JSystem(jcfg)
    jsys.spin(JSynthetic(jcfg, **kw))
    ds = SyntheticDataset(cfg, **kw)
    tsys = System(cfg, device="cpu")
    tsys.tracker._init_draws = JaxInitDraws(cfg.runtime.init_ransac_iters)
    tsys.spin(ds)
    jrep, trep = jsys.report(), tsys.report()
    assert jsys.tracker.state == jtr.OK and jrep["n_lost"] == 0, jrep
    assert tsys.tracker.state == ttr.OK and trep["n_lost"] == 0, trep
    assert tsys.kernels.tri_rows[2] > 0 and set(tsys.kernels.tri_rows) == {2}
    assert tsys.mapper.n_tri_points > 0
    j_ate, t_ate = _ate(jsys, ds).rmse, _ate(tsys, ds).rmse
    assert abs(t_ate - j_ate) < 0.02, (t_ate, j_ate)
    assert trep["n_frames"] == jrep["n_frames"]
