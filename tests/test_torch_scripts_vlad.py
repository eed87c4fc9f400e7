"""The port's image tools (sp_orb_slam_tpu_torch/scripts/) against the JAX
package's scripts/, on the CPU.

The JAX side runs the untouched scripts' `main()` with a patched
`sys.argv` and reads their JSON line (and the fit's .npz); the port's side
calls the tools' steps.  Cases:
- `spherical_kmeans` on one seeded bank in both (also a bank whose first
  pass leaves clusters dead): equal assignments, centroids within 1e-5;
- the fit at a small size (one training room, 8 frames a room, 8
  clusters; both held-out classes non-empty): the same selection, every
  stat within 1e-3, centroids and mean within 1e-4, `proj` up to the sign
  of each column;
- the codebooks the port writes (the fitted, whitened one and a seeded
  "cent" one) through both packages' `load_params`: the same global
  descriptors within 1e-5;
- an empty revisit or distinct class raises;
- validate_weights on the committed checkpoint: equal keypoint, pair and
  match counts, quantiles within 1e-3;
- vlad_rendered_stats on 8 frames: quantiles within 1e-3.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.models import netvlad as jvlad
from sp_orb_slam_tpu_torch.io.render import _rendered_loop_trajectory
from sp_orb_slam_tpu_torch.models import netvlad as tvlad
from sp_orb_slam_tpu_torch.models.weights import load_checkpoint
from sp_orb_slam_tpu_torch.scripts import _rail
from sp_orb_slam_tpu_torch.scripts import fit_vlad_centroids as tfit
from sp_orb_slam_tpu_torch.scripts import validate_weights as tval
from sp_orb_slam_tpu_torch.scripts import vlad_rendered_stats as tstats

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "sp_rendered.npz")
# the small fit: 160-frame rooms sampled every 22nd frame hold 2 revisit and
# 17 distinct pairs (the default 220 / 8 holds 11 and 216)
SMALL = dict(n_frames=160, stride=22, clusters=8)
TOL = 1e-3 + 1e-12  # JSON values rounded to 3 decimals, within 1e-3


def _jax_script(name):
    """A module of the JAX package's scripts/, imported by name as
    tests/test_depth_filter.py does."""
    path = os.path.join(REPO, "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


def _run_main(module, argv, monkeypatch, capsys):
    """The script's main() on `argv`; its last stdout line as JSON."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    capsys.readouterr()
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_kmeans(X, C):
    return _jax_script("fit_vlad_centroids").spherical_kmeans(X, C)


def _bank(case):
    rng = np.random.default_rng(7)
    centres = rng.normal(size=(6, 32))
    X = centres[rng.integers(0, 6, 300)] + 0.3 * rng.normal(size=(300, 32))
    if case == "dead":
        # half the rows one point: the initial draw takes it more than once,
        # and the copies past the first win no row (argmax takes the first)
        X[::2] = X[0]
    X = (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32)
    return X


@pytest.mark.parametrize("case", ["live", "dead"])
def test_spherical_kmeans_matches_jax(case):
    X, C = _bank(case), 8
    first = X[np.random.default_rng(0).choice(len(X), C, replace=False)]
    n_same = len(first) - len(np.unique(first, axis=0))
    assert (n_same > 0) == (case == "dead"), n_same
    want = _jax_kmeans(X, C)
    got = tfit.spherical_kmeans(torch.from_numpy(X), C).numpy()
    np.testing.assert_array_equal(np.argmax(X @ got.T, 1),
                                  np.argmax(X @ want.T, 1))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The small fit through both packages: (the JAX script's JSON line,
    its .npz, the port's `Fit`, the port's .npz path)."""
    tmp = tmp_path_factory.mktemp("fit")
    argv = ["--weights", WEIGHTS, "--train-seeds", "0",
            "--n-frames", str(SMALL["n_frames"]),
            "--stride", str(SMALL["stride"]),
            "--clusters", str(SMALL["clusters"]),
            "--out", str(tmp / "jax.npz")]
    jscript = _jax_script("fit_vlad_centroids")
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [jscript.__file__, *argv])
    out = io.StringIO()
    try:  # a module fixture has no capsys
        with contextlib.redirect_stdout(out):
            jscript.main()
    finally:
        mp.undo()
    res = tfit.fit(load_checkpoint(WEIGHTS), train_seeds=(0,),
                   device="cpu", **SMALL)
    port = tmp / "port.npz"
    np.savez(port, **res.save)
    return (json.loads(out.getvalue().strip().splitlines()[-1]),
            np.load(tmp / "jax.npz"), res, port)


def test_fit_matches_jax(fits):
    jout, jz, res, port = fits
    got = res.summary
    assert got["selected"] == jout["selected"]
    for k in ("clusters", "n_train_desc"):
        assert got[k] == jout[k], k
    assert sorted(got["stats"]) == sorted(jout["stats"])
    for key, st in jout["stats"].items():
        for k, v in st.items():
            assert abs(got["stats"][key][k] - v) <= TOL, (key, k)
    for k in ("selected_detector_margin", "random_init_detector_margin"):
        assert abs(got[k] - jout[k]) <= TOL, k
    tz = np.load(port)
    assert sorted(tz.files) == sorted(jz.files)
    for k in ("alpha", "residual"):
        assert float(tz[k]) == float(jz[k]), k
    np.testing.assert_allclose(tz["centroids"], jz["centroids"], atol=1e-4)
    np.testing.assert_allclose(tz["mean"], jz["mean"], atol=1e-4)
    if "proj" in jz.files:
        sign = np.sign((tz["proj"] * jz["proj"]).sum(0))
        sign[sign == 0] = 1
        np.testing.assert_allclose(tz["proj"] * sign, jz["proj"],
                                   atol=1e-4 * np.abs(jz["proj"]).max())
    else:
        for k in ("proj_seed", "out_dim"):
            assert int(tz[k]) == int(jz[k]), k


@pytest.mark.parametrize("kind", ["fitted", "seeded"])
def test_codebook_loads_in_both_packages(fits, kind, tmp_path):
    """The fitted codebook (whitened at this size: `proj` stored) and a
    seeded one (`proj_seed` + `out_dim`) give the same global descriptors
    through either package's load_params."""
    _, _, res, path = fits
    if kind == "seeded":
        z = np.load(path)
        sel = tfit.Selected(40.0, 0.0, "cent", torch.from_numpy(z["mean"]),
                            None)
        path = tmp_path / "seeded.npz"
        np.savez(path, **tfit.codebook(torch.from_numpy(z["centroids"]),
                                       sel, 4096))
    jp, tp = jvlad.load_params(str(path)), tvlad.load_params(str(path))
    assert ("proj_seed" in np.load(path).files) == (kind == "seeded")
    desc, valid = (t.numpy() for t in res.ev)
    got = tvlad.NetVLAD(tp, device="cpu")(*res.ev).numpy()
    want = np.stack([jvlad.global_descriptor_np(jp, d, v)
                     for d, v in zip(desc, valid)])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fit_writes_outside_weights_by_default():
    out = tfit.parse_args([]).out
    assert out == os.path.join(REPO, "out", "vlad_rendered.npz")


@pytest.mark.parametrize("empty", ["revisit", "distinct"])
def test_empty_pair_class_raises(empty):
    if empty == "revisit":  # 100 frames: the circle never returns
        n, stride = 100, 10
        idxs = list(range(0, n, stride))
    else:  # the start and the end of a 220-frame loop: one revisit pair
        n, stride = 220, 8
        idxs = [48, 216]
    poses = _rendered_loop_trajectory(n)
    with pytest.raises(ValueError, match=f"no {empty} pair"):
        _rail.pair_classes([poses[i] for i in idxs], idxs, stride)


def test_validate_weights_matches_jax(monkeypatch, capsys):
    want = _run_main(_jax_script("validate_weights"),
                     ["--weights", WEIGHTS], monkeypatch, capsys)
    got = tval.validate(load_checkpoint(WEIGHTS), device="cpu")
    assert sorted(got) == sorted(k for k in want if k != "weights")
    for k in ("n_kp", "n_gt_pairs", "init_matches"):
        assert got[k] == want[k], k
    for k, v in want.items():
        if isinstance(v, list) and k.endswith("p90"):
            np.testing.assert_allclose(got[k], v, atol=TOL, err_msg=k)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= (0.01 if k == "separation_p50"
                                       else TOL), k


def test_vlad_rendered_stats_matches_jax(monkeypatch, capsys):
    want = _run_main(_jax_script("vlad_rendered_stats"),
                     ["--weights", WEIGHTS, "--n-frames", "160",
                      "--stride", "22"], monkeypatch, capsys)
    got = tstats.stats(load_checkpoint(WEIGHTS), stride=22, n_frames=160,
                       device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("n_frames_sampled", "revisit_pairs"):
        assert got[k] == want[k], k
    for k in ("revisit", "distinct", "adjacent"):
        np.testing.assert_allclose(got[f"{k}_sim_p10_p50_p90"],
                                   want[f"{k}_sim_p10_p50_p90"], atol=TOL)
