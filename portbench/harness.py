"""Run one cell of `BENCHMARK.json` and print its result line.

Everything that belongs to one configuration, traffic mix, cell, metric,
kernel count or driver sits in a file of its own, found by name:

- `BENCHMARK.json`'s workload entry names the cell's configuration and
  traffic; its metric entries name the metrics;
- `portbench/configs/<config>.json` (the file the configuration entry
  names), `portbench/traffic/<traffic>.json`,
  `portbench/workloads/<cell>.json` (the cell's limits on the compared
  numbers);
- `portbench/drivers/<driver>.py` (the traffic file names it): `run(ctx)`;
- `portbench/metrics/<metric>.py`: `read(rec)`, the number or None;
- `portbench/counts/<function>.py` and `portbench/fragments/*.json`, read
  through `portbench/readers.py` and `portbench/trace.py`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

from portbench import modules_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """portbench/<kind>/<name>.py as a module of its own."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    key = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_"
                                         for c in name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: str, name: str) -> SimpleNamespace:
    """Everything one cell is made of, found by its name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, chips=w["chips"], entry=w,
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(root, "portbench", "traffic",
                                       f"{w['traffic']}.json")),
        limits=load_json(os.path.join(root, "portbench", "workloads",
                                      f"{name}.json"))["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def device_info(ctx, out: dict) -> dict:
    import torch

    info = {"platform": "gpu" if ctx.device.startswith("cuda") else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if ctx.device.startswith("cuda") else "cpu"),
            "count": ctx.chips,
            "memory_peak_bytes": out.get("memory", {}).get("peak_bytes", 0)}
    if "profile" in out:
        from portbench import trace

        info["busy_s"] = trace.busy_seconds(out["profile"]["device"])
        info["window_s"] = out["profile"]["seconds"]
    return info


def finite(v):
    return v if v is None or math.isfinite(v) else 1e30


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program=None, workers=None,
             t_start: float | None = None, readings: bool = False) -> dict:
    """One run of a cell; the result object (not printed).  With
    `readings`, it also holds every number the comparison read."""
    c = cell(root, name)
    ctx = SimpleNamespace(
        root=root, cell=name, config=c.config, traffic=c.traffic,
        seed=seed, seconds=seconds, trace=trace, device=device,
        program=program, workers=workers, chips=c.chips,
        t_start=time.perf_counter() if t_start is None else t_start)
    driver = load_module(root, "drivers", c.traffic["driver"])
    out = driver.run(ctx)
    from portbench import compare, trace as tr

    correct, checks = compare.judge(out["readings"], c.limits)
    rec = dict(out, cell=name, config=c.config, traffic=c.traffic,
               peaks=load_json(os.path.join(root, "portbench",
                                            "peaks.json")),
               functions=tr.functions(root), root=root)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = load_module(root, "metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": finite(float(v)),
                                  "unit": m["unit"]}
    result = {"correct": bool(correct and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info(ctx, out)}
    if trace and "profile" in out:
        result["breakdown"] = tr.breakdown(out["profile"])
    if readings:
        result["readings"] = out["readings"]
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    chips = cell(ROOT, a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=t_start)
    found = modules_check.forbidden(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
