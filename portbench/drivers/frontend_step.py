"""The frontend step served in a closed loop: B camera streams, one batch
a step, `in_flight` batches handed in before the oldest is collected.

A step hands the batch, a host float32 (B, H, W) array in [0, 1], to the
program's extractor (`sp_orb_slam_tpu_torch.extractor.make_extractor`),
runs the init matcher (`ops.cuda_match.match_init_batch`) from each
stream's previous features to its new ones, and, when collected, reads
back the packed host mirrors of the features
(`slam.kernels.TrackingKernels.fetch_features_host_batch`) and the match
indices.  A step's latency runs from its hand-in to its collect
returning.

`ControlProgram` puts the plain reference in the program's place,
computed one precision below the configuration's: it is what the
comparison must refuse (`portbench/tests/test_portbench_control.py`).
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from portbench import checkpoint, compare, reference, trace
from portbench import traffic as gen
from portbench.reference import matching

HOST_DTYPES = dict(uv=np.float32, score=np.float32, response=np.float32,
                   valid=bool, cov2_inv=np.float32, occ_grid=np.int32)


def port_config(cfg: dict):
    """The program's Config for a configuration file."""
    from sp_orb_slam_tpu_torch.config import load_config

    cam = cfg["camera"]
    return load_config(overrides={
        "camera": {k: cam[k] for k in ("width", "height", "fx", "fy", "cx",
                                       "cy")},
        "tracking": {"num_features": cfg["num_features"]},
        "runtime": {"max_keypoints": cfg["max_keypoints"]},
        "extractor": {k: cfg[k] for k in (
            "conf_thresh", "nms_dist", "border", "nms_iters", "cov_window",
            "cov_iters", "conv_packing")} | {"dtype": cfg["precision"]}})


class PortProgram:
    """The system under test: the port's extractor, init matcher and
    feature readback."""

    def __init__(self, cfg: dict, state: dict, device: str):
        from sp_orb_slam_tpu_torch.extractor import make_extractor
        from sp_orb_slam_tpu_torch.ops import cuda_match
        from sp_orb_slam_tpu_torch.slam.kernels import TrackingKernels

        pcfg = port_config(cfg)
        params = {k: torch.from_numpy(v) for k, v in state.items()}
        self.extract = make_extractor(pcfg, params, device=device)
        self.kernels = TrackingKernels(pcfg, device=device)
        self.match_init_batch = cuda_match.match_init_batch
        self.window = cfg["match"]["window"]
        self.ratio = cfg["match"]["ratio"]

    def hand_in(self, images: np.ndarray, prev):
        feats = self.extract(images)
        p = feats if prev is None else prev
        m12, _, _ = self.match_init_batch(p.desc, p.valid, p.uv, feats.desc,
                                          feats.uv, feats.valid,
                                          window=self.window,
                                          ratio=self.ratio)
        return feats, m12

    def collect(self, feats, m12):
        host = self.kernels.fetch_features_host_batch(feats,
                                                      feats.uv.shape[0])
        return host, m12.cpu().numpy()

    @staticmethod
    def outputs(feats) -> dict:
        """The device outputs the comparison judges."""
        return dict(desc=feats.desc, semi_dust=feats.semi_dust)

    @staticmethod
    def features(feats) -> dict:
        """A step's features as the next step's matcher reads them."""
        return dict(desc=feats.desc, uv=feats.uv, valid=feats.valid)


class ControlProgram:
    """The plain reference in the program's place, one precision below the
    configuration's: float8 e4m3 convolutions for bfloat16, TF32 for
    float32; the matcher's dot products in TF32 (below its float32)."""

    BELOW = {"bfloat16": "fp8", "float32": "tf32"}

    def __init__(self, cfg: dict, state: dict, device: str, block: int = 8):
        self.cfg = cfg
        self.device = device
        self.weights = reference.weights_on(state, device)
        self.precision = self.BELOW[cfg["precision"]]
        self.block = block

    def hand_in(self, images: np.ndarray, prev):
        x = torch.as_tensor(images, device=self.device)
        with torch.inference_mode():
            parts = [reference.extract(x[lo:lo + self.block], self.weights,
                                       self.cfg, self.precision)
                     for lo in range(0, x.shape[0], self.block)]
            f = {k: torch.cat([p[k] for p in parts])
                 for k in ("uv", "score", "valid", "occ_grid", "count",
                           "desc", "cov2", "response")}
            f["semi_dust"] = torch.cat([p["maps"].semi_dust for p in parts])
            p = f if prev is None else prev
            m = self.cfg["match"]
            m12 = matching.match(p["desc"], p["valid"], p["uv"], f["desc"],
                                 f["uv"], f["valid"], window=m["window"],
                                 ratio=m["ratio"], th=m["th_low"], tf32=True)
        return f, m12

    def collect(self, f, m12):
        cols = {k: f[k].cpu().numpy() for k in ("uv", "score", "response",
                                                 "valid", "occ_grid")}
        cols["cov2_inv"] = (1.0 / f["cov2"]).cpu().numpy()
        count = f["count"].cpu().numpy()
        host = [{k: cols[k][b].astype(HOST_DTYPES[k]) for k in cols}
                | {"count": int(count[b])} for b in range(len(count))]
        return host, m12.cpu().numpy()

    @staticmethod
    def outputs(f) -> dict:
        return dict(desc=f["desc"], semi_dust=f["semi_dust"])

    @staticmethod
    def features(f) -> dict:
        return dict(desc=f["desc"], uv=f["uv"], valid=f["valid"])


class Step:
    __slots__ = ("frame", "t_in", "enqueue_s", "feats", "m12",
                 "prev", "host", "m12_host", "latency_s")


class Loop:
    """The closed loop over the traffic's batches."""

    def __init__(self, program, batches: list, traffic: dict, sync):
        self.program = program
        self.batches = batches
        self.frames = traffic["frames"]
        self.in_flight = traffic["in_flight"]
        self.sync = sync
        self.k = 0
        self.prev = None
        self.pending: collections.deque = collections.deque()

    def hand_in(self) -> None:
        s = Step()
        s.frame = gen.frame_of_step(self.k, self.frames)
        s.prev = self.prev
        s.t_in = time.perf_counter()
        s.feats, s.m12 = self.program.hand_in(self.batches[s.frame],
                                              self.prev)
        s.enqueue_s = time.perf_counter() - s.t_in
        self.prev = s.feats
        self.k += 1
        self.pending.append(s)

    def collect(self) -> Step:
        s = self.pending.popleft()
        s.host, s.m12_host = self.program.collect(s.feats, s.m12)
        s.latency_s = time.perf_counter() - s.t_in
        return s

    def serve(self, on_collect, *, steps: int | None = None,
              seconds: float | None = None, annotate: bool = False):
        """Hand in `steps` steps, or steps until `seconds` have passed,
        collecting the oldest whenever `in_flight` are pending, then
        collect the rest: (wall seconds, steps handed in).  `annotate`
        marks each hand-in and collect for the profiler."""
        hand_in, collect = self.hand_in, self.collect
        if annotate:
            hand_in = _annotated("portbench/hand_in", hand_in)
            collect = _annotated("portbench/collect", collect)
        t0 = time.perf_counter()
        n = 0
        while (n < steps if steps is not None
               else time.perf_counter() - t0 < seconds):
            hand_in()
            n += 1
            if len(self.pending) >= self.in_flight:
                on_collect(collect())
        while self.pending:
            on_collect(collect())
        self.sync()
        return time.perf_counter() - t0, n


def _annotated(name: str, fn):
    def call():
        with torch.profiler.record_function(name):
            return fn()
    return call


class Reservoir:
    """A uniform sample of at most `size` collected steps, drawn from the
    seed as they come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 0x636B])
        self.items: list = []
        self.seen = 0

    def offer(self, s: Step) -> None:
        if len(self.items) < self.size:
            self.items.append(s)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = s
        self.seen += 1


def _step_inputs(s: Step, prev_host, cfg: dict) -> dict:
    """What the count files need of one traced step."""
    cam = cfg["camera"]
    return dict(B=len(s.host), H=int(cam["height"]), W=int(cam["width"]),
                K=cfg["max_keypoints"],
                uv=np.stack([h["uv"] for h in s.host]),
                valid=np.stack([h["valid"] for h in s.host]),
                prev_uv=np.stack([h["uv"] for h in prev_host]),
                prev_valid=np.stack([h["valid"] for h in prev_host]),
                raw_desc_bytes=2 if cfg["precision"] == "bfloat16" else 4)


def run(ctx) -> dict:
    """One run of a cell: set-up, warm-up, the window, the traced
    sub-window (with `--trace 1`), then the comparison."""
    cfg, traffic = ctx.config, ctx.traffic
    cuda = ctx.device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state = checkpoint.load(ctx.root, cfg["weights"])
    frames = gen.render_all(cfg["camera"], traffic, ctx.seed, ctx.workers)
    batches = gen.batches(frames)
    program = (ctx.program or PortProgram)(cfg, state, ctx.device)
    loop = Loop(program, batches, traffic, sync)
    loop.serve(lambda s: None, steps=traffic["warmup_steps"])
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    B = traffic["streams"]
    sample = Reservoir(-(-traffic["check_frames"] // B), ctx.seed)
    lat, enq = [], []
    last = []

    def on_collect(s: Step):
        lat.append(s.latency_s)
        enq.append(s.enqueue_s)
        sample.offer(s)
        last[:] = [s.host]

    seconds, n_steps = loop.serve(on_collect, seconds=ctx.seconds)
    out = dict(setup_s=setup_s, attempted=n_steps * B,
               failed=(n_steps - len(lat)) * B,
               window=dict(seconds=seconds, steps=len(lat),
                           frames=len(lat) * B, latencies_s=lat,
                           enqueue_s=enq))
    if cuda:
        window_peak = torch.cuda.max_memory_allocated()
    if ctx.trace:
        traced, prev = [], last[0]

        def keep(s: Step):
            nonlocal prev
            traced.append(_step_inputs(s, prev, cfg))
            prev = s.host

        rec = trace.capture(lambda: loop.serve(
            keep, steps=traffic["profile_steps"], annotate=True))
        rec.update(steps=len(traced), frames=len(traced) * B, inputs=traced)
        out["profile"] = rec
    if cuda:
        out["memory"] = dict(
            peak_bytes=max(setup_peak, window_peak,
                           torch.cuda.max_memory_allocated()),
            window_peak_bytes=window_peak)

    # the comparison, once the program's state is freed
    judged = [dict(images=batches[s.frame], host=s.host,
                   match12=s.m12_host, outs=program.outputs(s.feats),
                   prev=program.features(s.prev if s.prev is not None
                                         else s.feats))
              for s in sample.items]
    del sample, loop, program, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["readings"] = compare.readings(judged, state, cfg, ctx.device)
    return out
