"""Hierarchical named timers.

Rebuild of the reference's voxblox-derived timing utility
(include/orb_slam/utils/timing.h: `timing::Timer`/`Timing` with rolling
windows, sigma/min/max statistics and a printable table, :19-93,114-177).
Tags mirror the reference instrumentation (tracking/frame, tracking/dust,
tracking/local_map, extraction, mapping/*); `/`-separated tags render as a
hierarchy.

The port keeps its own copy of the JAX package's utils/timing.py.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict


class _Accumulator:
    """Rolling-window stats (reference window 50 samples, timing.h:19-93)."""

    def __init__(self, window: int = 50):
        self.samples = deque(maxlen=window)
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

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def std(self) -> float:
        n = len(self.samples)
        if n < 2:
            return 0.0
        m = self.mean
        return math.sqrt(sum((s - m) ** 2 for s in self.samples) / (n - 1))


class Timer:
    def __init__(self):
        self.tags: Dict[str, _Accumulator] = {}

    @contextmanager
    def span(self, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(tag, time.perf_counter() - t0)

    def add(self, tag: str, dt: float) -> None:
        self.tags.setdefault(tag, _Accumulator()).add(dt)

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
