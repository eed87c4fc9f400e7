"""LightGlue in the port (models/lightglue.py, matcher.py) against the plain
reference (reference/lightglue.py) on seeded random weights at the
published widths (256-d, 9 layers, 4 heads of 64) with a few keypoints
(B=2, K=64) on the CPU, and the init matcher's dispatch on the port's
normal path (`slam/kernels.init_body`, `parallel/mesh.multi_stream_step`).
"""

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from sp_orb_slam_tpu_torch import matcher as tmatcher
from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.models import lightglue as lg
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.models.superpoint import \
    init_params as sp_init_params
from sp_orb_slam_tpu_torch.ops import cuda_match
from sp_orb_slam_tpu_torch.parallel import mesh as pm
from sp_orb_slam_tpu_torch.slam import kernels as tk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, W, H = 2, 64, 752, 480
SEED = 20231001
# f32 against f32: the port's batched and fused-order products part from
# the reference's by rounding, 2e-5 at |L| ~ 17 after 9 layers (1e-6
# relative); bf16 projections and attention part by ~0.1, so 1e-3 holds
# the port to float32 and refuses a bfloat16 run
F32_ATOL = 1e-3


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_lightglue", os.path.join(REPO, "reference", "lightglue.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


@pytest.fixture(scope="module")
def state():
    return lg.init_params(SEED)


@pytest.fixture(scope="module")
def model(state):
    return lg.LightGlue(state).eval()


def _frames(seed=1, counts=((50, 64), (40, 60))):
    """Two frames of B rows: pixel keypoints, unit descriptors, the first
    `count` slots valid and the rest zero."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for n in counts:
        uv = torch.stack([torch.randint(0, W, (B, K), generator=g),
                          torch.randint(0, H, (B, K), generator=g)],
                         -1).float()
        d = torch.nn.functional.normalize(
            torch.randn(B, K, 256, generator=g), dim=-1)
        valid = torch.arange(K)[None] < torch.tensor(n)[:, None]
        out += [uv * valid[..., None], d * valid[..., None], valid]
    return out


def _port(model, frames, dtype=torch.float32):
    uv0, d0, v0, uv1, d1, v1 = frames
    with torch.inference_mode():
        return model(uv0, d0, v0, uv1, d1, v1, width=W, height=H,
                     compute_dtype=dtype)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def reference(state, frames):
    uv0, d0, v0, uv1, d1, v1 = frames
    return ref.log_assignment(state, uv0, d0, v0, uv1, d1, v1, width=W,
                              height=H)


def test_log_assignment_matches_reference_f32(model, frames, reference):
    """The full (B, M+1, N+1) log assignment within F32_ATOL of the
    reference, -inf exactly where it is; a bfloat16 run does not hold."""
    got = lg.full_assignment(*_port(model, frames))
    finite = torch.isfinite(reference)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool((got[~finite] == reference[~finite]).all())
    assert float((got - reference)[finite].abs().max()) < F32_ATOL
    bf16 = lg.full_assignment(*_port(model, frames, torch.bfloat16))
    assert float((bf16 - reference)[finite].abs().max()) > F32_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_slots_change_nothing_valid(model, frames, dtype):
    """Padded slots changed at random (keypoints and descriptors) leave the
    log assignment of every valid pair, the valid slots' dustbins and the
    matches bit-equal, and never match."""
    g = torch.Generator().manual_seed(7)
    noisy = list(frames)
    for i in (0, 3):
        pad = ~frames[i + 2]
        noisy[i] = torch.where(pad[..., None], torch.rand(
            B, K, 2, generator=g) * W, frames[i])
        noisy[i + 1] = torch.where(pad[..., None], torch.randn(
            B, K, 256, generator=g), frames[i + 1])
    a, b = _port(model, frames, dtype), _port(model, noisy, dtype)
    v0, v1 = frames[2], frames[5]
    pair = v0[:, :, None] & v1[:, None, :]
    assert torch.equal(a[0][pair], b[0][pair])
    assert bool(torch.isinf(b[0][~pair]).all())
    assert torch.equal(a[1][v0], b[1][v0]) and torch.equal(a[2][v1], b[2][v1])
    ma, mb = (lg.filter_matches(x[0], v0, v1, 0.0) for x in (a, b))
    for fields, sel in ((("match12", "score12", "best0", "arg0"), v0),
                        (("match21", "best1", "arg1"), v1)):
        for f in fields:
            assert torch.equal(getattr(ma, f)[sel], getattr(mb, f)[sel]), f
    # threshold 0: every mutual valid pair is kept, and only such pairs
    assert bool((mb.match12[~v0] == -1).all())
    assert bool((mb.match21[~v1] == -1).all())
    kept = mb.match12 >= 0
    assert int(kept.sum()) > 0
    assert bool(v1.gather(1, mb.match12.clamp_min(0).long())[kept].all())


def _planted(seed=3):
    """A core log assignment with strong matches planted on a permutation
    of half of the valid rows (and ties broken nowhere else), -inf at
    invalid pairs."""
    g = torch.Generator().manual_seed(seed)
    v0 = torch.arange(K)[None] < torch.tensor([50, 64])[:, None]
    v1 = torch.arange(K)[None] < torch.tensor([40, 60])[:, None]
    core = -8.0 - 4.0 * torch.rand(B, K, K, generator=g)
    for b in range(B):
        rows = torch.randperm(int(v0[b].sum()), generator=g)[:20]
        cols = torch.randperm(int(v1[b].sum()), generator=g)[:20]
        core[b, rows, cols] = torch.log(
            0.05 + 0.9 * torch.rand(20, generator=g))
    pair = v0[:, :, None] & v1[:, None, :]
    return core.masked_fill(~pair, -math.inf), v0, v1


def test_filter_matches_reference_on_planted_scores():
    """The port's filter gives the reference's matches, scores, bests and
    argmaxes on planted scores that do yield matches (some of them below
    the threshold)."""
    core, v0, v1 = _planted()
    full = torch.nn.functional.pad(core, (0, 1, 0, 1), value=-1.0)
    want = ref.filter_matches(full, v0, v1, 0.1)
    got = lg.filter_matches(core, v0, v1, 0.1)
    assert 0 < int(got.n_matches.min()) and int(got.n_matches.max()) < 20
    assert torch.equal(got.match12.long(), want["match0"])
    assert torch.equal(got.match21.long(), want["match1"])
    assert torch.equal(got.score12, want["score0"])
    for f in ("best0", "best1"):
        assert torch.equal(getattr(got, f), want[f]), f
    assert torch.equal(got.n_matches.long(), (want["match0"] >= 0).sum(1))
    assert got.match12.dtype == got.match21.dtype == torch.int32


def test_rotary_pairing_against_hand_formula():
    """Each pair (a, b) of a head's channels turns by its own angle:
    (a cos t - b sin t, b cos t + a sin t), as the reference's rotate."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4, 7, 64, generator=g)
    t = torch.randn(3, 1, 7, 32, generator=g)
    cos = t.cos().repeat_interleave(2, -1)
    sin = t.sin().repeat_interleave(2, -1)
    signed = sin.clone()
    signed[..., 0::2] *= -1
    got = lg.rotary(x, cos, signed)
    a, b = x[..., 0::2], x[..., 1::2]
    want = torch.stack([a * t.cos() - b * t.sin(),
                        b * t.cos() + a * t.sin()], -1).flatten(-2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(x * cos + ref.rotate(x) * sin, want, rtol=0,
                               atol=1e-6)


def test_state_dict_names_round_trip(state, tmp_path):
    """The published names and layouts: a module built from the state
    gives it back, and the reference's own writing of the published keys
    and initialisation (`init_state`) draws the same tensors; the
    published file's older names load renamed."""
    assert sum(v.numel() for v in state.values()) == 11_851_601
    written = ref.init_state(SEED)
    assert list(written) == list(state)
    assert all(torch.equal(written[k], state[k]) for k in state)
    shapes = {"posenc.Wr.weight": (32, 2),
              "transformers.0.self_attn.Wqkv.weight": (768, 256),
              "transformers.8.self_attn.ffn.0.weight": (512, 512),
              "transformers.8.self_attn.ffn.1.weight": (512,),
              "transformers.8.self_attn.ffn.3.weight": (256, 512),
              "transformers.4.cross_attn.to_qk.weight": (256, 256),
              "transformers.4.cross_attn.to_v.bias": (256,),
              "transformers.4.cross_attn.to_out.weight": (256, 256),
              "log_assignment.8.final_proj.weight": (256, 256),
              "log_assignment.8.matchability.weight": (1, 256),
              "token_confidence.7.token.0.weight": (1, 256)}
    for k, s in shapes.items():
        assert tuple(state[k].shape) == s, k
    assert "token_confidence.8.token.0.weight" not in state
    back = lg.LightGlue(state).state_dict()
    assert list(back) == list(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    old = {k.replace("transformers.3.self_attn", "self_attn.3")
            .replace("transformers.3.cross_attn", "cross_attn.3"): v
           for k, v in state.items()}
    assert "self_attn.3.Wqkv.weight" in old
    torch.save(old, tmp_path / "lg.pth")
    loaded = lg.load_state(str(tmp_path / "lg.pth"))
    assert set(loaded) == set(state)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    np.savez(tmp_path / "lg.npz", **{k: v.numpy() for k, v in state.items()})
    assert all(torch.equal(v, state[k]) for k, v in
               lg.load_state(str(tmp_path / "lg.npz")).items())


def _lg_config():
    return dataclasses.replace(
        Config(), init_matcher="lightglue", camera=dataclasses.replace(
            Config().camera, width=W, height=H),
        lightglue=dataclasses.replace(Config().lightglue,
                                      weights_seed=SEED))


def test_make_matcher_cpu_runs_eagerly(model, frames):
    """On the CPU every call of the closure runs eagerly, keeps no graph
    and gives the model and filter's matches, in match_init_batch's
    argument order and dtypes."""
    run = tmatcher.make_matcher(_lg_config(), device="cpu")
    uv0, d0, v0, uv1, d1, v1 = frames
    a, b = (run(d0, v0, uv0, d1, uv1, v1) for _ in range(2))
    assert run.calls == {"eager": 2} and not run.graphs
    want = lg.filter_matches(_port(model, frames)[0], v0, v1, 0.1)
    for f, x, y, z in zip(lg.Matches._fields, a, b, want):
        assert torch.equal(x, y) and torch.equal(x, z), f
    assert a.match12.shape == (B, K) and a.n_matches.shape == (B,)
    assert a.best0.shape == a.arg0.shape == a.best1.shape == (B, K)
    with pytest.raises(ValueError):
        tmatcher.init_matcher(dataclasses.replace(Config(),
                                                  init_matcher="bogus"))


def test_make_matcher_cpu_counts_no_uploads(frames):
    """The closure exposes its runner's `uploads`, which on the CPU counts
    nothing."""
    run = tmatcher.make_matcher(_lg_config(), device="cpu")
    uv0, d0, v0, uv1, d1, v1 = frames
    run(d0, v0, uv0, d1, uv1, v1)
    assert run.uploads == {} and run.calls == {"eager": 1}


class _Spy:
    """Counts the calls of a wrapped callable."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.fixture
def spies(monkeypatch):
    window = _Spy(cuda_match.match_init_batch)
    monkeypatch.setattr(cuda_match, "match_init_batch", window)
    glue = _Spy(lg.filter_matches)
    monkeypatch.setattr(lg, "filter_matches", glue)
    return window, glue


@pytest.mark.parametrize("choice", ["window", "lightglue"])
def test_init_body_reaches_the_configured_matcher(spies, frames, choice):
    """`TrackingKernels.init_two_view` (through `init_body`) runs
    match_init_batch under the default and LightGlue under
    init_matcher="lightglue", each once."""
    window, glue = spies
    cfg = dataclasses.replace(
        _lg_config() if choice == "lightglue" else Config(),
        runtime=dataclasses.replace(Config().runtime, max_keypoints=K))
    kern = tk.TrackingKernels(cfg, device="cpu")
    uv0, d0, v0, uv1, d1, v1 = (t[0].numpy() for t in frames)
    out = kern.init_two_view(d0, uv0, v0, uv0, d1, uv1, v1,
                             np.zeros((200, 8), np.int64))
    assert (window.n, glue.n) == ((1, 0) if choice == "window" else (0, 1))
    assert out["match12"].shape == (K,)


def test_init_body_gives_lightglue_frame_1s_keypoints(frames):
    """Where the windowed matcher's search centres `prev_uv` are not frame
    1's keypoints, `init_two_view` under LightGlue hands the matcher frame
    1's own keypoints, and its matches are `make_matcher`'s on them
    (threshold 0, so that every mutual pair counts)."""
    cfg = dataclasses.replace(
        _lg_config(),
        lightglue=dataclasses.replace(_lg_config().lightglue,
                                      filter_threshold=0.0),
        runtime=dataclasses.replace(Config().runtime, max_keypoints=K))
    uv0, d0, v0, uv1, d1, v1 = (t[:1] for t in frames)
    centres = uv0.flip(1)  # another frame's positions in frame 1's slots
    want = tmatcher.make_matcher(cfg, device="cpu")(d0, v0, uv0, d1, uv1,
                                                    v1).match12[0]
    kern = tk.TrackingKernels(cfg, device="cpu")
    seen = []

    def recorded(*args):
        seen.append(args[2])
        return real(*args)

    real, kern._matcher = kern._matcher, recorded
    out = kern.init_two_view(*(t[0].numpy() for t in (d0, uv0, v0, centres,
                                                      d1, uv1, v1)),
                             np.zeros((200, 8), np.int64))
    assert len(seen) == 1 and torch.equal(seen[0], uv0)
    assert int((want >= 0).sum()) > 0
    assert np.array_equal(out["match12"], want.numpy())


@pytest.mark.parametrize("choice", ["window", "lightglue"])
def test_multi_stream_step_reaches_the_configured_matcher(spies, choice):
    """`multi_stream_step` through `build_sharded_step` runs
    match_init_batch under the default and LightGlue under
    init_matcher="lightglue", once a call, its int32 matches as the
    windowed matcher's."""
    window, glue = spies
    h, w, nf, k = 64, 96, 40, 48
    cfg = dataclasses.replace(
        _lg_config() if choice == "lightglue" else Config(),
        camera=dataclasses.replace(Config().camera, width=w, height=h))
    params = sp_init_params(torch.Generator().manual_seed(0))
    step = pm.build_sharded_step(pm.make_mesh(1, "cpu"), params,
                                 num_features=nf, max_keypoints=k,
                                 compute_dtype=torch.float32, cfg=cfg)
    rng = np.random.default_rng(0)
    images = rng.random((2, h, w), np.float32)
    with torch.inference_mode():
        prev = pm.extract(SuperPoint(params).eval(), torch.from_numpy(images),
                          num_features=nf, max_keypoints=k)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mp = np.zeros((2, k, 3), np.float32)
    feats, m12, n, _, _ = step(images, prev.desc, prev.uv, prev.valid, Tcw,
                               mp, np.zeros((2, k), bool),
                               np.array([80.0, 80.0, 48.0, 32.0], np.float32))
    assert (window.n, glue.n) == ((1, 0) if choice == "window" else (0, 1))
    assert m12.dtype == n.dtype == torch.int32 and m12.shape == (2, k)


def test_reference_copies_are_identical():
    with open(os.path.join(REPO, "reference", "lightglue.py"), "rb") as f:
        a = f.read()
    with open(os.path.join(REPO, "portbench", "reference", "lightglue.py"),
              "rb") as f:
        assert f.read() == a
