"""Port parity for the slice as a whole: extract + init match of
sp_orb_slam_tpu_torch against the JAX package on the same images and
parameters, on the CPU at a small size (96x128, K=128); plus the port's
own copies of the config tree and the rendered-room dataset."""

import collections
import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.extractor import extract as jextract
from sp_orb_slam_tpu.io.render import RenderedDataset as JRendered
from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.ops.pallas_match import match_init_batch as jmatch
from sp_orb_slam_tpu_torch.config import (PORT_ONLY, Config,
                                          LightGlueConfig, load_config)
from sp_orb_slam_tpu_torch.extractor import Features, extract, make_extractor
from sp_orb_slam_tpu_torch.io.render import RenderedDataset
from sp_orb_slam_tpu_torch.models import superpoint as tsp
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.models.weights import params_from_jax
from sp_orb_slam_tpu_torch.ops import cuda_match
from sp_orb_slam_tpu_torch.utils import graphs

torch.set_num_threads(2)

H, W, NF, K = 96, 128, 100, 128
EXACT = ("uv", "valid", "occ_grid", "count")


@pytest.fixture(scope="module")
def jparams():
    return jsp.init_params(jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((2, H, W), np.float32)


@pytest.fixture(scope="module")
def both(jparams, images):
    jf = jextract(jparams, jnp.asarray(images), num_features=NF,
                  max_keypoints=K)
    with torch.no_grad():
        tf = extract(SuperPoint(params_from_jax(jparams)),
                     torch.from_numpy(images), num_features=NF,
                     max_keypoints=K)
    return jf, tf


def test_extract_matches_jax(both):
    jf, tf = both
    assert tf._fields == jf._fields
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                      np.asarray(getattr(jf, f)), err_msg=f)
    assert int(tf.count.min()) > 20
    for f, atol in (("desc", 1e-4), ("cov2", 1e-4), ("cov2_inv", 1e-4),
                    ("score", 1e-5), ("response", 1e-5),
                    ("dense_dust", 1e-5), ("semi_dust", 2e-4),
                    ("heat_inv", 1e-4)):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), atol=atol,
                                   err_msg=f)
    assert tf.heat is None and jf.heat is None


def test_extract_then_match_matches_jax(both):
    """bench.py's composition: frame 0 against frame 1."""
    jf, tf = both
    want = jmatch(jf.desc[:1], jf.valid[:1], jf.uv[:1], jf.desc[1:],
                  jf.uv[1:], jf.valid[1:], window=100, ratio=0.9, tm=128,
                  interpret=True)
    got = cuda_match.match_init_batch(tf.desc[:1], tf.valid[:1], tf.uv[:1],
                                      tf.desc[1:], tf.uv[1:], tf.valid[1:],
                                      window=100, ratio=0.9)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_make_extractor_cpu(jparams, images):
    cfg = dataclasses.replace(Config(), tracking=dataclasses.replace(
        Config().tracking, num_features=NF), runtime=dataclasses.replace(
        Config().runtime, max_keypoints=K))
    run = make_extractor(cfg, params_from_jax(jparams), device="cpu")
    feats = run(images)
    assert isinstance(feats, Features)
    assert feats.uv.device.type == "cpu"
    assert feats.heat_inv is None  # no production consumer
    jf = jextract(jparams, jnp.asarray(images), num_features=NF,
                  max_keypoints=K)
    np.testing.assert_array_equal(feats.uv.numpy(), np.asarray(jf.uv))


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _uploaded_floor(like):
    """The heat floor as it was: log(1e-3) computed on the host and copied
    to `like`'s device."""
    return torch.log(torch.tensor(1e-3, dtype=torch.float32)).to(like.device)


def test_log_floor_is_the_uploaded_floor():
    x = torch.zeros(3)
    got, want = tsp.log_floor(x), _uploaded_floor(x)
    assert (got.dtype, got.shape, got.device) == (want.dtype, want.shape,
                                                  want.device)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nan", [False, True])
def test_forward_heat_bit_equal_to_maximum_floor(jparams, images, nan,
                                                 monkeypatch):
    """The forward's heat maps with the host-constant floor are bit-equal to
    the uploaded floor's, a NaN pixel's NaN included."""
    model = SuperPoint(params_from_jax(jparams))
    x = torch.from_numpy(images).clone()
    if nan:
        x[0, 40, 60] = float("nan")
    with torch.no_grad():
        got = model(x, with_heat=True)
        monkeypatch.setattr(tsp, "log_floor", _uploaded_floor)
        want = model(x, with_heat=True)
    for f in ("heat", "heat_inv"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert bool(torch.isnan(got.heat_inv).any()) == nan


def test_pack_round_trip(both):
    """The graph path's copy-out: every field of a call's Features through
    one flat byte buffer, bit-equal, with its dtype and shape, each at an
    aligned offset, and a field left out as None."""
    _, tf = both
    flat, layout = graphs.pack(tf)
    assert flat.dtype == torch.uint8 and flat.dim() == 1
    back = graphs.unpack(flat.clone(), layout, Features)
    for name, a, b, f in zip(Features._fields, tf, back, layout):
        if a is None:
            assert b is None and f is None, name
            continue
        assert f[0] % graphs._ALIGN == 0, name
        assert (b.dtype, b.shape) == (a.dtype, a.shape), name
        assert torch.equal(_bits(b), _bits(a)), name


def test_make_extractor_cpu_runs_eagerly(jparams, images):
    """On the CPU every call runs eagerly and keeps no graph."""
    cfg = dataclasses.replace(Config(), tracking=dataclasses.replace(
        Config().tracking, num_features=NF), runtime=dataclasses.replace(
        Config().runtime, max_keypoints=K))
    run = make_extractor(cfg, params_from_jax(jparams), device="cpu")
    a, b = run(images), run(images)
    assert run.calls == {"eager": 2} and not run.graphs
    for f in EXACT:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_make_extractor_cpu_counts_no_uploads(jparams, images):
    """The closure exposes its runner's `uploads`, which on the CPU counts
    nothing: eager calls stage no input."""
    cfg = dataclasses.replace(Config(), tracking=dataclasses.replace(
        Config().tracking, num_features=NF), runtime=dataclasses.replace(
        Config().runtime, max_keypoints=K))
    run = make_extractor(cfg, params_from_jax(jparams), device="cpu")
    run(images)
    assert isinstance(run.uploads, collections.Counter)
    assert run.uploads == {} and run.calls == {"eager": 1}


class _Sum(NamedTuple):
    total: torch.Tensor
    none: torch.Tensor | None


def test_graph_runner_cpu_stages_nothing(images):
    """On the CPU the runner calls the function eagerly on the host input
    as it is: no graph, no pinned buffer, no upload counted."""
    def fn(x, *, scale):
        return _Sum(x.sum((1, 2)) * scale, None)

    runner = graphs.GraphRunner(fn, torch.device("cpu"), "sum",
                                lambda a: (torch.as_tensor(a),))
    got = [runner(images, dict(scale=2.0)) for _ in range(2)]
    assert runner.calls == {"eager": 2} and runner.uploads == {}
    assert not runner.graphs and runner._stream is None
    want = torch.from_numpy(images).sum((1, 2)) * 2.0
    for g in got:
        assert torch.equal(g.total, want) and g.none is None


@pytest.mark.parametrize("piece,shape,dtype,pieces", [
    (4096, (3, 40, 52), torch.float32, 7),     # the last piece ragged
    (4096, (2, 60, 80), torch.bfloat16, 5),
    (1 << 20, (3, 40, 52), torch.float32, 1),  # on this thread
    (4096, (4096,), torch.uint8, 1),
])
def test_stage_copies_every_byte(monkeypatch, piece, shape, dtype, pieces):
    """`_stage` copies a host input into the pinned buffer and on into
    the static input, byte for byte, whole or in pieces (here plain host
    tensors in the buffers' places)."""
    monkeypatch.setattr(graphs, "STAGE_PIECE_BYTES", piece)
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(shape, generator=g) * 255).to(dtype)
    host, dev = torch.zeros_like(x), torch.zeros_like(x)
    p = graphs._Pinned(host, graphs._bytes(host),
                       graphs._bytes(host).numpy(), graphs._bytes(dev))
    cuts = graphs._cuts(x.numel() * x.element_size())
    assert len(cuts) - 1 == pieces
    graphs._stage(p, x)
    assert torch.equal(graphs._bytes(host), graphs._bytes(x))
    assert torch.equal(graphs._bytes(dev), graphs._bytes(x))


def test_extract_rejects_bad_options(jparams, images):
    model = SuperPoint(params_from_jax(jparams))
    x = torch.from_numpy(images)
    for kw in (dict(cov_radius=9, border=8), dict(nms_method="pallas"),
               dict(cov_method="bogus"), dict(desc_method="stencil"),
               dict(conv_packing="s2d4"), dict(emission="bogus")):
        with pytest.raises(ValueError):
            extract(model, x, num_features=NF, max_keypoints=K, **kw)


def jax_tree(cfg) -> dict:
    """The port's config as a dict, less its port-only keys (the init
    matcher's choice and LightGlue's settings), which the JAX package lacks."""
    d = dataclasses.asdict(cfg)
    for k in PORT_ONLY:
        d.pop(k)
    return d


def test_config_copy_matches_jax():
    """The port's tree is the JAX package's plus PORT_ONLY, whose defaults
    keep the JAX package's init matcher."""
    assert jax_tree(Config()) == dataclasses.asdict(JConfig())
    over = {"extractor": {"dtype": "bfloat16"}, "camera": {"width": 640}}
    from sp_orb_slam_tpu.config import load_config as jload

    assert (jax_tree(load_config(overrides=over))
            == dataclasses.asdict(jload(overrides=over)))
    assert (Config().init_matcher, Config().lightglue) == (
        "window", LightGlueConfig())


def test_rendered_dataset_copy_matches_jax():
    """The port's renderer copy gives the JAX package's images and ray
    casts (small camera keeps the CPU cost down)."""
    cam = {"width": 160, "height": 96, "fx": 76.0, "fy": 84.0, "cx": 80.0,
           "cy": 48.0}
    from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
    from sp_orb_slam_tpu_torch.config import _merge_dataclass

    ds = RenderedDataset(_merge_dataclass(Config(), {"camera": cam}),
                         n_frames=20, seed=3, noise_seed=1)
    jds = JRendered(jmerge(JConfig(), {"camera": cam}), n_frames=20, seed=3,
                    noise_seed=1)
    for i in (0, 7):
        a, b = ds.frame(i), jds.frame(i)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
        assert a.timestamp == b.timestamp
    uv = np.array([[3.0, 5.0], [80.0, 48.0], [150.0, 90.0]], np.float32)
    for a, b in zip(ds.raycast(ds.poses[4], uv), jds.raycast(jds.poses[4],
                                                            uv)):
        np.testing.assert_array_equal(a, b)
