"""Replaying a closure's calls on the card as captured CUDA graphs.

`GraphRunner` runs a function of device tensors that returns a NamedTuple
of tensors: eagerly on the CPU, and on a CUDA device as one captured graph
for each key (the inputs' shapes and the keywords) that recurs.  The
extractor (`extractor.make_extractor`) and the LightGlue matcher
(`matcher.make_matcher`) replay through it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from sp_orb_slam_tpu_torch.ops import _build
from sp_orb_slam_tpu_torch.utils.timing import span

# input keys (shape and options) a closure keeps a graph for, the least
# recently used dropped first
GRAPHS_KEPT = 4
_ALIGN = 256  # bytes: each output field's offset in a graph's flat buffer
# bytes of a piece of a pageable host input's staging copy: an input of
# one piece is staged on the calling thread, a larger one on the staging
# threads (a 1.44 MB frame staged on one thread beat five pieces on the
# pool, and 2 MiB pieces beat 8 or 32 at B=32, on the H100's host)
STAGE_PIECE_BYTES = 2 << 20


class _Graph(NamedTuple):
    """One captured call."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple         # the static inputs, on the device
    staging: list         # each input's `_Pinned` buffer, or None
    copied: torch.cuda.Event  # the end of the last copy out of staging
    flat: torch.Tensor    # uint8: the outputs, copied in by the graph
    layout: tuple         # each output field's (offset, dtype, shape), or None
    kind: type            # the outputs' NamedTuple
    launches: dict        # hand-written kernel launches a replay runs


def pack(out: tuple) -> tuple[torch.Tensor, tuple]:
    """(one flat byte buffer holding a copy of every field of `out`, a
    NamedTuple of tensors, each field's (offset, dtype, shape) there or
    None)."""
    layout, size = [], 0
    for t in out:
        if t is None:
            layout.append(None)
            continue
        layout.append((size, t.dtype, tuple(t.shape)))
        size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    device = next(t.device for t in out if t is not None)
    flat = torch.empty(size, dtype=torch.uint8, device=device)
    for t, f in zip(out, layout):
        if f is not None:
            _field(flat, *f).copy_(t)
    return flat, tuple(layout)


def unpack(flat: torch.Tensor, layout: tuple, kind: type):
    """The `kind` (a NamedTuple) that `pack` wrote into `flat`, as views
    of it."""
    return kind(*(None if f is None else _field(flat, *f) for f in layout))


def _field(flat: torch.Tensor, offset: int, dtype: torch.dtype,
           shape: tuple) -> torch.Tensor:
    n = math.prod(shape) * dtype.itemsize
    return flat[offset:offset + n].view(dtype).view(shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class _Pinned(NamedTuple):
    """A graph's pinned host buffer for one of its static inputs."""

    host: torch.Tensor    # pinned, the static input's shape and dtype
    host_bytes: torch.Tensor  # `host` as flat bytes
    host_np: np.ndarray   # the same bytes, as numpy's view
    dev_bytes: torch.Tensor   # the static input as flat bytes

    @classmethod
    def of(cls, static: torch.Tensor) -> "_Pinned":
        host = torch.empty(static.shape, dtype=static.dtype, pin_memory=True)
        return cls(host, _bytes(host), _bytes(host).numpy(), _bytes(static))


_stagers_made = threading.Lock()
_stagers_pool = None


def _stagers() -> concurrent.futures.ThreadPoolExecutor:
    """The process's staging threads, one for each of torch's intra-op
    threads, made on first use.  Between copies they wait blocked, where
    torch's own intra-op threads spin after each parallel copy, holding
    the cores that the launches and syncs of the host's next step need."""
    global _stagers_pool
    with _stagers_made:
        if _stagers_pool is None:
            _stagers_pool = concurrent.futures.ThreadPoolExecutor(
                torch.get_num_threads(), thread_name_prefix="stage")
        return _stagers_pool


def _cuts(n: int) -> list[int]:
    """The byte offsets that cut `n` bytes into the staging copy's pieces,
    with `0` and `n`."""
    return [*range(0, n, STAGE_PIECE_BYTES), n]


def _stage(p: _Pinned, x: torch.Tensor) -> None:
    """Copy the pageable host tensor `x` into `p.host`, then on to the
    card without waiting for it, on the current stream: on this thread
    where `x` is one piece (`_cuts`), else in pieces on the staging
    threads, each run of pieces copied on to the card as soon as it and
    the pieces before it are in."""
    src = _bytes(x.to(p.host.dtype).contiguous()).numpy()
    cuts = _cuts(src.size)
    if len(cuts) == 2:
        np.copyto(p.host_np, src)
        p.dev_bytes.copy_(p.host_bytes, non_blocking=True)
        return
    pool = _stagers()
    pieces = [pool.submit(np.copyto, p.host_np[a:b], src[a:b])
              for a, b in zip(cuts, cuts[1:])]
    i = 0
    while i < len(pieces):
        lo = cuts[i]
        pieces[i].result()
        i += 1
        while i < len(pieces) and pieces[i].done():
            pieces[i].result()
            i += 1
        p.dev_bytes[lo:cuts[i]].copy_(p.host_bytes[lo:cuts[i]],
                                      non_blocking=True)


class GraphRunner:
    """A closure's calls of `fn(*inputs, **kw)`, a function of device
    tensors that returns a NamedTuple of tensors: on a CUDA device the
    first call of a key (the inputs' shapes and `kw`) runs
    eagerly, which warms up its kernels and caches, the second captures
    the call as a CUDA graph and replays it, and later calls replay it;
    the CPU runs every call eagerly.  `inputs(args)` turns a call's
    arguments into the tensors `fn` takes, on the host or the device.

    A replay copies the inputs into the graph's static inputs and the
    outputs out of its static buffers into a fresh one, so a call's
    outputs outlive the next replay.  The copy in syncs nothing: an input
    on the device or in pinned host memory is copied as it is, and a
    pageable host input is first copied on the host, in parallel, into a
    pinned buffer the graph holds (`_stage`).  Outside its pool
    a graph reads only its static inputs and the model's weights, which
    the model casts and packs once and holds (models/superpoint.py,
    models/lightglue.py), so nothing inside a capture packs or uploads,
    whatever other closures run between.  The capture is thread-local:
    the online mode's threads use the card meanwhile.  The copy in runs
    in the span `<name>/upload`, its host copy into a pinned buffer in
    `<name>/upload/stage`, the replay and the copy out in
    `<name>/replay`.  `calls` counts the calls by how they ran ("eager",
    "capture", "replay"); `uploads` counts the inputs of capture and
    replay calls by how they reached the static inputs ("staged",
    "direct") and the staging copies that had to wait for the buffer's
    previous copy to the card ("waited"); `graphs` holds the
    `GRAPHS_KEPT` newest keys (a `_Graph`, or None for a key run once),
    and dropping one frees its graph, its memory pool and its pinned
    buffers."""

    def __init__(self, fn, dev: torch.device, name: str, inputs):
        self.fn = fn
        self.dev = dev
        self.name = name
        self.inputs = inputs
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.calls: collections.Counter = collections.Counter()
        self.uploads: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._stream = None  # the captures' stream, on the closure's device

    def _eager(self, xs: tuple, kw: dict):
        with span(f"{self.name}/upload"):
            xs = tuple(x.to(self.dev) for x in xs)
        with torch.inference_mode():
            return self.fn(*xs, **kw)

    def __call__(self, args, kw: dict):
        if self.dev.type != "cuda":
            with self._lock:
                self.calls["eager"] += 1
            return self._eager(self.inputs(args), kw)
        with self._lock, torch.cuda.device(self.dev), torch.inference_mode():
            xs = self.inputs(args)
            key = (*(tuple(x.shape) for x in xs), tuple(kw.items()))
            if key not in self.graphs:
                self.graphs[key] = None
                if len(self.graphs) > GRAPHS_KEPT:
                    self.graphs.popitem(last=False)
                self.calls["eager"] += 1
                return self._eager(xs, kw)
            self.graphs.move_to_end(key)
            g = self.graphs[key]
            if g is None:
                static = tuple(torch.empty(x.shape, dtype=x.dtype,
                                           device=self.dev) for x in xs)
                staging, copied = [None] * len(xs), torch.cuda.Event()
            else:
                static, staging, copied = g.inputs, g.staging, g.copied
            with span(f"{self.name}/upload"):
                self._upload(static, staging, copied, xs)
            if g is None:
                g = self.graphs[key] = self._capture(static, staging,
                                                     copied, kw)
                self.calls["capture"] += 1
            else:
                self.calls["replay"] += 1
            with span(f"{self.name}/replay"):
                g.graph.replay()
                _build.add_launches(g.launches)
                return unpack(g.flat.clone(), g.layout, g.kind)

    def _upload(self, static: tuple, staging: list,
                copied: torch.cuda.Event, xs: tuple) -> None:
        """Copy a call's inputs into a graph's static inputs on the current
        stream, the replay's, without waiting for the card.  A device or
        pinned host input is copied as it is.  A pageable host input is
        staged through its pinned buffer in `staging` (allocated on first
        use); `copied` is recorded after the copies, and a later staging
        copy waits on it only where the card has not yet read the
        buffer."""
        staged = False
        for i, (s, x) in enumerate(zip(static, xs)):
            if x.is_cuda or x.is_pinned():
                s.copy_(x, non_blocking=True)
                self.uploads["direct"] += 1
                continue
            if staging[i] is None:
                staging[i] = _Pinned.of(s)
            elif not copied.query():
                copied.synchronize()
                self.uploads["waited"] += 1
            with span(f"{self.name}/upload/stage"):
                _stage(staging[i], x)
            self.uploads["staged"] += 1
            staged = True
        if staged:
            copied.record()

    def _capture(self, inputs: tuple, staging: list,
                 copied: torch.cuda.Event, kw: dict) -> _Graph:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.dev)
        graph = torch.cuda.CUDAGraph()
        with _build.captured() as launches, torch.cuda.graph(
                graph, stream=self._stream,
                capture_error_mode="thread_local"):
            out = self.fn(*inputs, **kw)
            flat, layout = pack(out)
        return _Graph(graph, inputs, staging, copied, flat, layout,
                      type(out), launches)
