"""Hierarchical named timers, and the program's spans on the profiler's
clock.

Rebuild of the reference's voxblox-derived timing utility
(include/orb_slam/utils/timing.h: `timing::Timer`/`Timing` with rolling
windows, sigma/min/max statistics and a printable table, :19-93,114-177).
Tags mirror the reference instrumentation (tracking/frame, tracking/dust,
tracking/local_map, extraction, mapping/*); `/`-separated tags render as a
hierarchy.

`span(name)` is the one span mechanism: while a torch.profiler session
records, it opens a range `sp/<name>` in the profiler's own clock, beside
the device's events; otherwise it returns a shared no-op context.
`Timer.span` opens one around each of its samples.

The port's own copy of the JAX package's utils/timing.py, with `span`
added and every sample kept.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "sp/"
_OFF = nullcontext()


def span(name: str):
    """A context marking `name` for the profiler, when one records.

    The range is FUNCTION-scoped (`_RecordFunctionFast`): the profiler
    does not mirror it onto the device's timeline as it does a
    `torch.profiler.record_function` (a user annotation), so a trace's
    device events stay the device's work."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(PREFIX + name)


class _Accumulator:
    """Every sample up to `cap` (the newest kept), with the reference's
    rolling-window stats over the newest `window` (timing.h:19-93)."""

    def __init__(self, window: int = 50, cap: int = 1 << 16):
        self.window = window
        self.samples = deque(maxlen=cap)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = 0.0

    def add(self, dt: float) -> None:
        self.samples.append(dt)
        self.total += dt
        self.count += 1
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    def _rolling(self) -> List[float]:
        return list(itertools.islice(reversed(self.samples), self.window))

    @property
    def mean(self) -> float:
        r = self._rolling()
        return sum(r) / len(r) if r else 0.0

    @property
    def std(self) -> float:
        r = self._rolling()
        n = len(r)
        if n < 2:
            return 0.0
        m = sum(r) / n
        return math.sqrt(sum((s - m) ** 2 for s in r) / (n - 1))


class Timer:
    def __init__(self):
        self.tags: Dict[str, _Accumulator] = {}

    @contextmanager
    def span(self, tag: str):
        """A host-clock sample of `tag`, inside `span(tag)`."""
        with span(tag):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(tag, time.perf_counter() - t0)

    def add(self, tag: str, dt: float) -> None:
        self.tags.setdefault(tag, _Accumulator()).add(dt)

    def samples(self) -> Dict[str, List[float]]:
        """{tag: its kept samples in seconds, oldest first}."""
        return {tag: list(a.samples) for tag, a in self.tags.items()}

    def table(self) -> str:
        """Printable hierarchy (Timing::Print, timing.h:114-177): total,
        samples, rolling mean +- sigma, [min, max] in ms."""
        header = (f"{'tag':<30} {'total[s]':>9} {'n':>6} "
                  f"{'mean+-sigma[ms]':>20} {'[min, max][ms]':>22}")
        lines = [header]
        for tag in sorted(self.tags):
            a = self.tags[tag]
            depth = tag.count("/")
            label = "  " * depth + tag.rsplit("/", 1)[-1] if depth else tag
            mn = 0.0 if a.min is math.inf else a.min
            lines.append(
                f"{label:<30} {a.total:9.2f} {a.count:6d} "
                f"{a.mean * 1e3:10.2f} +- {a.std * 1e3:6.2f} "
                f"[{mn * 1e3:8.2f}, {a.max * 1e3:8.2f}]")
        return "\n".join(lines)
