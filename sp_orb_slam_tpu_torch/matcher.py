"""The two-view init matcher, by the config's choice.

`Config.init_matcher` picks it: "window" (the default) is the windowed
brute-force match of SearchForInitialization (`ops/cuda_match.py`
`match_init_batch`), "lightglue" the LightGlue matcher
(`models/lightglue.py`) at its published sizes, set by `Config.lightglue`.
`match_init` is the one dispatch that `slam/kernels.init_body` and
`parallel/mesh.multi_stream_step` call; `make_matcher` is LightGlue's
serving closure, beside `extractor.make_extractor`, replayed on the card
as one CUDA graph for each input shape that recurs (`utils/graphs.py`).
"""

from __future__ import annotations

import functools

import torch

from sp_orb_slam_tpu_torch.config import Config
from sp_orb_slam_tpu_torch.models import lightglue
from sp_orb_slam_tpu_torch.models.lightglue import LightGlue, Matches
from sp_orb_slam_tpu_torch.ops import cuda_match
from sp_orb_slam_tpu_torch.utils.graphs import GraphRunner
from sp_orb_slam_tpu_torch.utils.timing import span

MATCHERS = ("window", "lightglue")


def lightglue_state(cfg: Config) -> dict[str, torch.Tensor]:
    """The configured LightGlue weights: the file `cfg.lightglue.weights`,
    else seeded random weights (`weights_seed`)."""
    lg = cfg.lightglue
    if lg.weights:
        return lightglue.load_state(lg.weights)
    return lightglue.init_params(lg.weights_seed)


def _match(model: LightGlue, desc0, valid0, uv0, desc1, uv1, valid1, *,
           width: int, height: int, threshold: float,
           compute_dtype: torch.dtype) -> Matches:
    core, _, _ = model(uv0, desc0, valid0, uv1, desc1, valid1, width=width,
                       height=height, compute_dtype=compute_dtype)
    return lightglue.filter_matches(core, valid0, valid1, threshold)


def _tensors(args) -> tuple:
    return tuple(torch.as_tensor(a) for a in args)


def make_matcher(cfg: Config, params=None,
                 device: str | torch.device = "cuda"):
    """LightGlue's closure for a config: `run(desc0, valid0, uv0, desc1,
    uv1, valid1)` matches frame 0's (B, M) slots to frame 1's (B, N), in
    `match_init_batch`'s argument order (unit descriptors (B, K, 256),
    valid (B, K) bool, pixel uv (B, K, 2) float32, normalised at the
    config's camera size), and returns `models.lightglue.Matches`.

    `params` is a LightGlue state dict (default: `lightglue_state(cfg)`);
    the compute dtype is the extractor's.  The model and every call run on
    `device`, which defaults to the card and raises without one.  On the
    card a shape that recurs is replayed as a CUDA graph; the closure's
    `calls`, `uploads` and `graphs` are its runner's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the matcher on the CPU")
    lg = cfg.lightglue
    state = params if params is not None else lightglue_state(cfg)
    model = LightGlue(state).to(dev).eval()
    runner = GraphRunner(functools.partial(_match, model), dev,
                         "match/lightglue", _tensors)
    kw = dict(width=cfg.camera.width, height=cfg.camera.height,
              threshold=float(lg.filter_threshold),
              compute_dtype=(torch.bfloat16
                             if cfg.extractor.dtype == "bfloat16"
                             else torch.float32))

    def run(desc0, valid0, uv0, desc1, uv1, valid1) -> Matches:
        with span("match/lightglue"):
            return runner((desc0, valid0, uv0, desc1, uv1, valid1), kw)

    run.calls = runner.calls
    run.uploads = runner.uploads
    run.graphs = runner.graphs
    return run


def init_matcher(cfg: Config, device: str | torch.device = "cuda"):
    """The matcher `match_init` takes for a config: None for "window",
    `make_matcher`'s closure on `device` for "lightglue"."""
    if cfg.init_matcher not in MATCHERS:
        raise ValueError(f"unknown init_matcher {cfg.init_matcher!r}")
    return (make_matcher(cfg, device=device)
            if cfg.init_matcher == "lightglue" else None)


def match_init(matcher, desc1, valid1, uv1, prev_uv, desc2, uv2, valid2, *,
               window: float = 100, ratio: float = 0.9):
    """Frame 1's (B, M) slots matched to frame 2's (B, N): (match12 (B, M)
    int32 or -1, n_matches (B,) int32, match21 (B, N) int32 or -1), by the
    windowed matcher (`window`, `ratio`) around the search centres
    `prev_uv` when `matcher` is None, else by the LightGlue closure
    `matcher` (`init_matcher`) on frame 1's own keypoints `uv1`."""
    if matcher is None:
        return cuda_match.match_init_batch(desc1, valid1, prev_uv, desc2,
                                           uv2, valid2, window=window,
                                           ratio=ratio)
    m = matcher(desc1, valid1, uv1, desc2, uv2, valid2)
    return m.match12, m.n_matches, m.match21
