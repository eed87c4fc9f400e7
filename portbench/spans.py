"""The program's own spans in a traced sub-window, and the arithmetic the
span readers (`portbench/metrics/`) share.

While the profiler records, the port opens FUNCTION-scope ranges named
`sp/<stage>` (`sp_orb_slam_tpu_torch/utils/timing.py` `span`): the
extraction and its stages, the init match, the feature readback.
`trace.capture` keeps them among the host events, on the clock of the
device events.  The profiler does not mirror such ranges onto the
device's timeline, so the device events stay the device's work.

A span's time is the union of its events' intervals (as
`trace.busy_intervals` unites device events); the device's idle
time inside a span is that union less its overlap with the union of the
device events; a call lies inside a span when it starts there.  Every
reader returns None where the trace holds no span it reads, as a run of
a program without spans gives.
"""

from __future__ import annotations

import bisect

from portbench import readers, trace

PREFIX = "sp/"
# blocking CUDA runtime calls: the host waits on the device in each
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))
LAUNCHES = ("cudaLaunch", "cuLaunch")  # name prefixes of kernel launches


def _length(iv) -> int:
    return sum(e - s for s, e in iv)


def _overlap(a, b) -> int:
    """ns that two lists of disjoint sorted intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(iv, t: int) -> bool:
    k = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return k >= 0 and iv[k][0] <= t < iv[k][1]


def _spans(rec: dict, match):
    """(the traced sub-window, the union of its host events whose name
    `match` accepts), or None where there is no such event."""
    p = readers.profile(rec)
    if p is None:
        return None
    iv = trace.busy_intervals(r for r in p["host"] if match(r[0]))
    return (p, iv) if iv else None


def ms_per_step(rec: dict, *names: str) -> float | None:
    """Host ms a traced step inside the named spans."""
    found = _spans(rec, names.__contains__)
    if found is None:
        return None
    p, iv = found
    return _length(iv) / 1e6 / p["steps"]


def idle_ms_per_step(rec: dict, *names: str) -> float | None:
    """Device idle ms a traced step while the host is inside the named
    spans; None where the trace holds no device event."""
    found = _spans(rec, names.__contains__)
    if found is None or not found[0]["device"]:
        return None
    p, iv = found
    busy = trace.busy_intervals(p["device"])
    return (_length(iv) - _overlap(iv, busy)) / 1e6 / p["steps"]


def calls_per_step(rec: dict, calls) -> float | None:
    """Host calls named in `calls` a traced step that start inside any
    `sp/` span."""
    found = _spans(rec, lambda name: name.startswith(PREFIX))
    if found is None:
        return None
    p, iv = found
    n = sum(1 for name, s, _ in p["host"] if name in calls
            and _inside(iv, s))
    return n / p["steps"]


def table(p: dict) -> dict[str, dict]:
    """{span: host ms, kernel launches and blocking syncs a step that start
    inside it} for each `sp/` span of a traced sub-window `p` (a parent's
    figures hold its children's)."""
    out, steps = {}, p["steps"]
    for name in sorted({r[0] for r in p["host"] if r[0].startswith(PREFIX)}):
        iv = trace.busy_intervals(r for r in p["host"] if r[0] == name)
        inside = [r[0] for r in p["host"] if _inside(iv, r[1])]
        out[name] = dict(
            ms=_length(iv) / 1e6 / steps,
            launches=sum(n.startswith(LAUNCHES) for n in inside) / steps,
            syncs=sum(n in SYNCS for n in inside) / steps)
    return out
