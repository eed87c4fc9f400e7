"""SuperPoint training of the port (train/superpoint_train.py and the
training forward of models/superpoint.py) against the JAX package's
train/superpoint_train.py, on the CPU, at full channel widths on small
images (96x64, B=2):

- the host part (Harris labels, cell centres, correspondences, perturbed
  poses, a 1-scene x 2-pair pool, the batch draws) bit for bit;
- `train_forward`, the loss terms and all 24 gradients, from the same
  parameters carried across by `params_from_jax`;
- the cosine schedule, and 3 training steps;
- `init_params`, `save_npz` into both packages' `load_checkpoint`, the
  command line on `--device cpu`, and the card as the default device.

The full-size comparison behind the chip gate on the loss's fall:
    JAX_PLATFORMS=cpu python -m tests.test_torch_train {jax|port} [steps]
trains either package on the CPU at 320x240, B=8, from its own seeded
init on the 2-scene x 16-pair pool of seed 0 and prints the history.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sp_orb_slam_tpu.config import Config as JConfig
from sp_orb_slam_tpu.config import _merge_dataclass as jmerge
from sp_orb_slam_tpu.io.render import RenderedDataset as JRendered
from sp_orb_slam_tpu.models import superpoint as jsp
from sp_orb_slam_tpu.models import weights as jweights
from sp_orb_slam_tpu.train import superpoint_train as jt
from sp_orb_slam_tpu_torch.io.render import RenderedDataset
from sp_orb_slam_tpu_torch.models import superpoint as tsp
from sp_orb_slam_tpu_torch.models import weights as tweights
from sp_orb_slam_tpu_torch.train import superpoint_train as tt

torch.set_num_threads(2)

STEPS, BATCH = 3, 2


def _cam(width, height, fx):
    return {"camera": {"width": width, "height": height, "fx": fx,
                       "fy": fx, "cx": width / 2.0, "cy": height / 2.0,
                       "fps": 20.0}}


CAM = _cam(96, 64, 78.0)


@pytest.fixture(scope="module")
def pools():
    return (jt.build_pool(jmerge(JConfig(), CAM), 1, 2, seed=0,
                          verbose=False),
            tt.build_pool(tt.camera_config(96, 64, 78.0), 1, 2, seed=0,
                          verbose=False))


@pytest.fixture(scope="module")
def jparams():
    return jsp.init_params(jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def trained(pools, jparams):
    """3 steps of both trainers from the same parameters and seed, every
    step logged."""
    jpool, tpool = pools
    jp, jhist = jt.train(None, jpool, steps=STEPS, batch=BATCH, seed=5,
                         params=jparams, log_every=1, verbose=True)
    state, thist = tt.train(None, tpool, steps=STEPS, batch=BATCH, seed=5,
                            params=tweights.params_from_jax(jparams),
                            log_every=1, verbose=True, device="cpu")
    return jp, jhist, state, thist


def test_host_labels_and_correspondences_bit_equal():
    cfg = tt.camera_config(96, 64, 78.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jmerge(JConfig(), CAM))
    ds, jds = (RenderedDataset(cfg, n_frames=1, seed=7),
               JRendered(jmerge(JConfig(), CAM), n_frames=1, seed=7))
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    Ta, jTa = ds.random_pose(rng), jds.random_pose(jrng)
    Tb, jTb = tt._perturbed_pose(rng, Ta), jt._perturbed_pose(jrng, jTa)
    np.testing.assert_array_equal(Tb, jTb)
    img = ds.render(Ta)
    np.testing.assert_array_equal(img, jds.render(jTa))
    np.testing.assert_array_equal(tt.harris_response(img),
                                  jt.harris_response(img))
    labels = tt.harris_cell_labels(img)
    np.testing.assert_array_equal(labels, jt.harris_cell_labels(img))
    assert labels.dtype == np.int32 and labels.shape == (8, 12)
    assert (labels[0] == 64).all() and (labels[:, -1] == 64).all()
    np.testing.assert_array_equal(tt.cell_centers(64, 96),
                                  jt.cell_centers(64, 96))
    corr = tt.cell_correspondence(ds, Ta, Tb)
    np.testing.assert_array_equal(corr, jt.cell_correspondence(jds, jTa,
                                                               jTb))
    assert corr.dtype == np.int32 and (corr >= 0).any()


def test_pool_and_batches_bit_equal(pools):
    jpool, tpool = pools
    assert sorted(jpool) == sorted(tpool)
    for k in jpool:
        assert jpool[k].dtype == tpool[k].dtype, k
        np.testing.assert_array_equal(tpool[k], jpool[k], err_msg=k)
    assert tpool["img_a"].shape == (2, 64, 96)
    assert tpool["corr"].shape == (2, 8 * 12)
    # the JAX trainer's draws (train():263-272) for two steps
    rng = np.random.default_rng(5 + 17)
    draws = tt.batches(tpool, BATCH, seed=5)
    for _ in range(2):
        idx = rng.integers(0, 2, BATCH)
        want = []
        for imgs in (jpool["img_a"], jpool["img_b"]):
            x = imgs[idx].astype(np.float32)
            x = x + rng.normal(0, 2.0, x.shape)
            gain = rng.uniform(0.8, 1.2, (BATCH, 1, 1))
            off = rng.uniform(-20, 20, (BATCH, 1, 1))
            want.append(np.asarray(jnp.asarray(
                np.clip(x * gain + off, 0, 255) / 255.0, jnp.float32)))
        got = next(draws)
        for a, b in zip(got, want + [jpool[k][idx] for k in
                                     ("lab_a", "lab_b", "corr")]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_train_forward_matches_jax(jparams):
    model = tsp.SuperPoint(tweights.params_from_jax(jparams))
    images = np.random.default_rng(1).random((2, 64, 96), np.float32)
    js, jd = jt.train_forward(jparams, jnp.asarray(images))
    ts, td = model.train_forward(torch.from_numpy(images))
    assert ts.shape == (2, 8, 12, 65) and td.shape == (2, 8, 12, 256)
    assert ts.requires_grad and td.requires_grad
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               atol=1e-4)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               atol=1e-5)
    # the 1e-8 clamp: an all-zero descriptor head gives zeros, not NaN
    state = tweights.params_from_jax(jparams)
    state["convDb.weight"].zero_()
    state["convDb.bias"].zero_()
    _, d0 = tsp.SuperPoint(state).train_forward(torch.from_numpy(images))
    assert torch.equal(d0, torch.zeros_like(d0))


def test_loss_and_gradients_match_jax(pools, jparams):
    """Loss, det and desc at relative 1e-5; each of the 24 gradients (the
    weights OIHW against JAX's HWIO transposed) at max|diff| <= 1e-4 of
    its max|g|."""
    _, tpool = pools
    batch = next(tt.batches(tpool, BATCH, seed=2))
    (jl, (jdet, jdl)), jg = jax.value_and_grad(
        jt.make_loss_fn(), has_aux=True)(jparams, *map(jnp.asarray, batch))
    model = tsp.SuperPoint(tweights.params_from_jax(jparams))
    tl, (tdet, tdl) = tt.make_loss_fn()(model, *map(torch.from_numpy, batch))
    tl.backward()
    for got, want in ((tl, jl), (tdet, jdet), (tdl, jdl)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert float(jdl) > 0 and float(jdet) > 0
    n = 0
    for name, *_ in tsp.LAYERS:
        for key, want in (("weight", np.transpose(np.asarray(jg[name]["w"]),
                                                  (3, 2, 0, 1))),
                          ("bias", np.asarray(jg[name]["b"]))):
            got = getattr(getattr(model, name), key).grad.numpy()
            assert got.shape == want.shape
            scale = np.abs(want).max()
            assert scale > 0, (name, key)
            assert np.abs(got - want).max() <= 1e-4 * scale, (name, key)
            n += 1
    assert n == 24


def test_cosine_schedule_matches_optax():
    steps, lr = 7, 1e-3
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, tt.cosine_decay(steps))
    got = []
    for _ in range(steps + 2):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        lam.step()
    want = [float(sched(t)) for t in range(steps + 2)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == lr and got[-1] == got[-2] == pytest.approx(0.05 * lr)


def test_adam_matches_optax():
    """torch's Adam under the LambdaLR schedule computes optax's
    adam(cosine_decay_schedule) update: the same gradient sequence (some
    entries zero or near it) gives the same parameters at float32
    rounding."""
    steps, lr = 4, 1e-3
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 50)).astype(np.float32)
    grads = rng.standard_normal((steps + 1, 3, 50)).astype(np.float32)
    grads[:, 0, :5] = 0.0
    grads[:, 1, :5] *= 1e-9
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))
    jp, st = jnp.asarray(p0), None
    st = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tp], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(topt, tt.cosine_decay(steps))
    for g in grads:
        up, st = opt.update(jnp.asarray(g), st)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        topt.step()
        sched.step()
        # float32 rounding at the parameters' scale (|p| < 4: an ulp is
        # at most 4.8e-7, 5e-4 of an lr-sized update); the near-zero
        # gradient entries take the same steps in both
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=5e-7)
    assert np.abs(p0).max() < 4


def test_short_training_matches_jax(trained, pools, jparams):
    """3 training steps of both packages from the same parameters and
    batches, every step logged.

    Steps 0 and 1 agree at relative 1e-4.  Step 2 follows the second
    update, and there the packages part by more than their arithmetic:
    Adam's first update is lr * g / (|g| + eps), about lr * sign(g) for
    any |g| >> eps = 1e-8, so a gradient entry of ~1e-9 (1e-8 of max|g|,
    under the rounding of either package's sums) moves by up to lr = 1e-3
    either way, and the loss at these sizes is sensitive to a handful of
    such moves (JAX's own gradient at the port's parameters after update
    1 differs from its gradient at its own by up to 4e-2 of max|g| while
    the port's gradient at JAX's parameters agrees at 3e-6).  So step 2 is
    held at relative 1e-3 (measured here: loss 2.0e-4, det 4.07e-4, desc
    1.8e-5; steps 0 and 1 at most 1.04e-7), and the port's step-2 loss is
    held at relative
    1e-5 to JAX's loss at the port's own parameters: the gap is the
    parameters', not the computation's.  Each final tensor agrees within
    2 * STEPS * lr, the most Adam's normalised steps can part, and all but
    1 % of its entries (one of a 64-entry bias) within 1e-4."""
    jp, jhist, state, thist = trained
    assert [h[0] for h in thist] == [h[0] for h in jhist] == [0, 1, 2]
    th, jh = np.array(thist)[:, 1:], np.array(jhist)[:, 1:]
    np.testing.assert_allclose(th[:2], jh[:2], rtol=1e-4)
    np.testing.assert_allclose(th[2], jh[2], rtol=1e-3)
    # the port's parameters after two updates, through train()'s step
    _, tpool = pools
    model = tsp.SuperPoint(tweights.params_from_jax(jparams))
    step = tt.make_train_step(model, STEPS)
    draws = tt.batches(tpool, BATCH, seed=5)
    for _ in range(2):
        step(*map(torch.from_numpy, next(draws)))
    p2 = jax.tree_util.tree_map(jnp.asarray,
                                tweights.params_to_jax(model.state_dict()))
    jl, _ = jt.make_loss_fn()(p2, *map(jnp.asarray, next(draws)))
    np.testing.assert_allclose(th[2, 0], float(jl), rtol=1e-5)
    got = tweights.params_to_jax(state)
    for name in jp:
        for key in ("w", "b"):
            d = np.abs(got[name][key] - np.asarray(jp[name][key]))
            assert d.max() <= 2 * STEPS * 1e-3, (name, key, d.max())
            assert (d > 1e-4).sum() <= max(1, 1e-2 * d.size), (
                name, key, (d > 1e-4).sum())
    assert all(v.device.type == "cpu" for v in state.values())


def test_train_leaves_params_unchanged(pools, jparams):
    _, tpool = pools
    params = tweights.params_from_jax(jparams)
    before = {k: v.clone() for k, v in params.items()}
    state, hist = tt.train(None, tpool, steps=1, batch=1, params=params,
                           verbose=False, device="cpu")
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert not torch.equal(state["conv1a.weight"], before["conv1a.weight"])
    assert len(hist) == 1 and np.isfinite(hist[0][1])


def test_init_params():
    a = tsp.init_params(torch.Generator().manual_seed(0))
    b = tsp.init_params(torch.Generator().manual_seed(0))
    c = tsp.init_params(torch.Generator().manual_seed(1))
    assert list(a) == [f"{n}.{k}" for n, *_ in tsp.LAYERS
                       for k in ("weight", "bias")]
    for name, cin, cout, k in tsp.LAYERS:
        w, bias = a[f"{name}.weight"], a[f"{name}.bias"]
        assert w.shape == (cout, cin, k, k) and bias.shape == (cout,)
        assert w.dtype == bias.dtype == torch.float32
        fan_in = cin * k * k
        assert w.abs().max() <= np.sqrt(6.0 / fan_in)
        assert bias.abs().max() <= 1.0 / np.sqrt(fan_in)
        # uniform over the bound: the spread reaches most of it
        assert w.abs().max() > 0.9 * np.sqrt(6.0 / fan_in)
        assert torch.equal(w, b[f"{name}.weight"])
        assert not torch.equal(w, c[f"{name}.weight"])
    # the JAX package's loader takes it
    jweights._convert_state_dict({k: v.numpy() for k, v in a.items()})


def test_save_npz_round_trip(tmp_path, jparams):
    state = tweights.params_from_jax(jparams)
    path = str(tmp_path / "port.npz")
    tweights.save_npz(state, path)
    back = jweights.load_checkpoint(path)
    for name in jparams:
        for key in ("w", "b"):
            np.testing.assert_array_equal(back[name][key],
                                          np.asarray(jparams[name][key]))
    again = tweights.load_checkpoint(path)
    assert all(torch.equal(again[k], state[k]) for k in state)
    # the same file as the JAX package writes
    jpath = str(tmp_path / "jax.npz")
    jweights.save_npz(jparams, jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    for name, p in tweights.params_to_jax(state).items():
        np.testing.assert_array_equal(p["w"], np.asarray(jparams[name]["w"]))


def test_main_on_cpu_writes_a_checkpoint_both_packages_read(tmp_path,
                                                            capsys):
    out = str(tmp_path / "sp.npz")
    tt.main(["--device", "cpu", "--steps", "2", "--batch", "1",
             "--scenes", "1", "--pairs", "1", "--width", "96", "--height",
             "64", "--fx", "78", "--out", out])
    log = capsys.readouterr().out
    assert "[pool] 1 pairs" in log and "[train] step 1:" in log
    assert f"[train] saved {out}" in log
    jp = jweights.load_checkpoint(out)
    state = tweights.load_checkpoint(out)
    assert set(jp) == {n for n, *_ in tsp.LAYERS}
    for name, p in tweights.params_to_jax(state).items():
        np.testing.assert_array_equal(p["w"], jp[name]["w"])
        np.testing.assert_array_equal(p["b"], jp[name]["b"])


def test_train_defaults_to_the_card(pools):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    _, tpool = pools
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.train(None, tpool, steps=1, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.main(["--steps", "1", "--scenes", "1", "--pairs", "1"])


def full_size_training(package, steps=200):
    """Train `package` ("jax" or "port") on the CPU from its own init of
    seed 0: 320x240 (the size weights/sp_rendered.npz was trained at), B=8,
    the 2-scene x 16-pair pool of seed 0.  Returns the history and the
    seconds."""
    mod, cfg = ((jt, jmerge(JConfig(), _cam(320, 240, 260.0)))
                if package == "jax" else
                (tt, tt.camera_config(320, 240, 260.0)))
    pool = mod.build_pool(cfg, n_scenes=2, pairs_per_scene=16, seed=0)
    t0 = time.time()
    kw = {} if package == "jax" else {"device": "cpu"}
    _, hist = mod.train(cfg, pool, steps=steps, batch=8, seed=0,
                        log_every=10, **kw)
    return dict(package=package, steps=steps, history=hist,
                seconds=time.time() - t0)


if __name__ == "__main__":
    import json
    import sys

    torch.set_num_threads(os.cpu_count() or 1)
    print(json.dumps(full_size_training(sys.argv[1],
                                        *map(int, sys.argv[2:]))))
