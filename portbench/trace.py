"""The device trace of a short steady sub-window and what is read from it.

`capture` runs a callable under torch.profiler (CPU and CUDA activities)
and keeps, in the profiler's own clock (ns): every device event (kernels,
memcpys, memsets) and the host's events (the benchmark's
`portbench/...` annotations, PyTorch operators, CUDA runtime calls).
`classify` gives each device event its function through the kernel-name
fragment files (`portbench/fragments/*.json`); the readers in
`portbench/metrics/` and the `breakdown` of a traced run read the result.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import time

OTHER = None        # a kernel of no function: plain PyTorch
TRANSFER = "transfer"  # host <-> device copies
ANNOTATION = "portbench/"


def functions(root: str) -> dict[str, dict]:
    """{function: {"layer": .., "fragments": [...]}} from every fragment
    file; a function's fragments are the union of its files'."""
    out: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(root, "portbench",
                                              "fragments", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        fn = out.setdefault(spec["function"],
                            {"layer": spec["layer"], "fragments": []})
        if fn["layer"] != spec["layer"]:
            raise ValueError(f"{path}: function {spec['function']} has "
                             f"layers {fn['layer']} and {spec['layer']}")
        fn["fragments"] += spec["fragments"]
    return out


def function_of(name: str, fns: dict) -> str | None:
    """The function whose longest fragment the kernel name holds, else
    None."""
    best, size = None, 0
    for fn, spec in fns.items():
        for frag in spec["fragments"]:
            if frag in name and len(frag) > size:
                best, size = fn, len(frag)
    return best


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        return ("transfer" if ("HtoD" in name or "DtoH" in name)
                else "copy")
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def capture(fn) -> dict:
    """Run fn() under the profiler; {"seconds": the host wall of the
    sub-window, "device": [[name, start_ns, dur_ns], ...], "host":
    [[name, start_ns, dur_ns], ...]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = [e.name(), int(e.start_ns()), int(e.duration_ns())]
        if e.device_type() == DeviceType.CUDA:
            # the profiler mirrors host annotations onto the device's
            # timeline: they are ranges, not device work
            if not row[0].startswith(("ProfilerStep", ANNOTATION)):
                device.append(row)
        else:
            host.append(row)
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return {"seconds": seconds, "device": device, "host": host}


def busy_intervals(device: list) -> list[tuple[int, int]]:
    """The union of the device events as disjoint [start, end) in ns."""
    out: list[list[int]] = []
    for _, s, d in sorted(device, key=lambda r: r[1]):
        e = s + max(d, 0)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(device: list) -> float:
    return sum(e - s for s, e in busy_intervals(device)) / 1e9


def by_name(device: list) -> dict[str, tuple[float, int]]:
    """{event name: (device seconds, count)}."""
    out: dict[str, list] = {}
    for name, _, dur in device:
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += dur / 1e9
        acc[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def seconds_by(device: list, fns: dict) -> dict:
    """Device seconds by what ran: each function, `transfer` (HtoD and
    DtoH copies) and None (every other kernel, copy or memset)."""
    out: dict = {}
    for name, (sec, _) in by_name(device).items():
        kind = kind_of(name)
        key = (TRANSFER if kind == "transfer"
               else function_of(name, fns) if kind == "kernel" else OTHER)
        out[key] = out.get(key, 0.0) + sec
    return out


def _label(host_sorted, starts, annotations, t) -> str:
    """What the host was doing at time t: the benchmark's annotation that
    holds t and the innermost host event that holds t."""
    ann = next((n for n, s, d in annotations if s <= t <= s + d), "outside")
    i = bisect.bisect_right(starts, t) - 1
    inner = None
    for j in range(i, max(i - 400, -1), -1):
        name, s, d = host_sorted[j]
        if s + d >= t and not name.startswith(ANNOTATION):
            inner = name
            break
    return f"{ann.removeprefix(ANNOTATION)}: {inner or 'python'}"


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each at most `top` entries of [name, seconds]."""
    device, host = rec["device"], rec["host"]
    ops = sorted(((name, sec) for name, (sec, _) in by_name(device).items()),
                 key=lambda x: -x[1])[:top]
    busy = busy_intervals(device)
    starts = [r[1] for r in host]
    annotations = [r for r in host if r[0].startswith(ANNOTATION)]
    idle: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 > e0:
            key = _label(host, starts, annotations, (e0 + s1) // 2)
            idle[key] = idle.get(key, 0.0) + (s1 - e0) / 1e9
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
