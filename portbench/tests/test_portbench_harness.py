"""The harness finds what a later change adds as files, the traffic is
the seed's, and the JAX check compares whole top-level names."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

from portbench import harness, modules_check, render, trace, traffic
from portbench.tests.conftest import ROOT, TINY_CAMERA, make_root


def tree_digest(base):
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_without_edits(tmp_path):
    root = make_root(tmp_path)
    pb = os.path.join(root, "portbench")
    before = tree_digest(pb)
    # a configuration, a traffic mix and a cell, as files
    with open(os.path.join(pb, "configs", "tiny-f32-config.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "added-config"
    with open(os.path.join(pb, "configs", "added-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "added.json"), "w") as f:
        json.dump(dict(traffic.check(dict(
            driver="added_driver", streams=1, frames=2,
            trajectory_frames=10, in_flight=1, warmup_steps=1,
            profile_steps=1, check_frames=1))), f)
    with open(os.path.join(pb, "workloads", "added-cell.json"), "w") as f:
        json.dump({"limits": {"x": 1.0}}, f)
    # a driver, a per-layer metric, a kernel count and its fragments
    with open(os.path.join(pb, "drivers", "added_driver.py"), "w") as f:
        f.write("def run(ctx):\n    return dict(readings={'x': 0.5},"
                " attempted=1, failed=0, setup_s=1.0,\n"
                "        window=dict(seconds=1.0, steps=1, frames=1,"
                " latencies_s=[0.01], enqueue_s=[0.001]))\n")
    with open(os.path.join(pb, "metrics", "added_metric.py"), "w") as f:
        f.write("def read(rec):\n    return 7.0\n")
    with open(os.path.join(pb, "counts", "added_fn.py"), "w") as f:
        f.write("def count(x, config):\n"
                "    return dict(flops=0.0, bytes=1e6, peak='fp32')\n")
    with open(os.path.join(pb, "fragments", "added_fn.k.json"), "w") as f:
        json.dump({"function": "added_fn", "layer": "post",
                   "fragments": ["added_kernel"]}, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="added-config", source="test",
                                 file="portbench/configs/added-config.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="added-cell", config="added-config",
                                   traffic="added", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="added_metric", unit="ms", better="lower", source="host_clock",
        layer="test", moves="frames_per_s", workloads=["added-cell"]))
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    c = harness.cell(root, "added-cell")
    assert c.config["name"] == "added-config"
    assert c.traffic["driver"] == "added_driver"
    assert [m["name"] for m in c.per_layer][-1] == "added_metric"
    fns = trace.functions(root)
    assert fns["added_fn"]["fragments"] == ["added_kernel"]
    assert trace.function_of("void added_kernel<1>(float*)", fns) == \
        "added_fn"
    assert harness.load_module(root, "counts", "added_fn").count(
        {}, {})["bytes"] == 1e6
    res = harness.run_cell(root, "added-cell", 1, 1.0, False, device="cpu")
    assert res["correct"] and res["checks"]["x"]["value"] == 0.5
    assert set(res["metrics"]) == {"frames_per_s", "latency_ms_p95",
                                   "setup_s"}
    res = harness.run_cell(root, "added-cell", 1, 1.0, True, device="cpu")
    assert res["metrics"]["added_metric"]["value"] == 7.0
    after = tree_digest(pb)
    assert all(after[k] == v for k, v in before.items())


def test_every_cell_of_the_benchmark_resolves():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        c = harness.cell(ROOT, w["name"])
        traffic.check(c.traffic)
        harness.load_module(ROOT, "drivers", c.traffic["driver"])
        assert c.limits
        for m in c.end_to_end + c.per_layer:
            assert callable(harness.load_module(ROOT, "metrics",
                                                m["name"]).read)


def test_traffic_is_the_seeds():
    t = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                    "b32-closed.json")))
    big = 2 ** 31 + 12345
    assert traffic.streams(t, big) == traffic.streams(t, big)
    assert traffic.streams(t, big) != traffic.streams(t, big + 1)
    assert len({s[0] for s in traffic.streams(t, big)}) == t["streams"]
    small = dict(t, streams=2, frames=2)
    a = traffic.render_all(TINY_CAMERA, small, big, workers=0)
    b = traffic.render_all(TINY_CAMERA, small, big, workers=0)
    c = traffic.render_all(TINY_CAMERA, small, big + 1, workers=0)
    assert a.shape == (2, 2, 120, 160) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert [traffic.frame_of_step(k, 4) for k in range(8)] == \
        [0, 1, 2, 3, 2, 1, 0, 1]


def test_frozen_renderer_matches_the_ports():
    from sp_orb_slam_tpu_torch.config import load_config
    from sp_orb_slam_tpu_torch.io.render import RenderedDataset

    cfg = load_config(overrides={"camera": TINY_CAMERA})
    ds = RenderedDataset(cfg, n_frames=220, seed=7, noise_seed=3)
    mine = render.render_frames(TINY_CAMERA, 220, 7, 3, [0, 100])
    assert np.array_equal(mine[0], ds.frame(0).image)
    assert np.array_equal(mine[1], ds.frame(100).image)


def test_jax_check_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "sp_orb_slam_tpu", "sp_orb_slam_tpu.ops.nms",
            "sp_orb_slam_tpu_torch", "sp_orb_slam_tpu_torch.ops.nms",
            "jaxtyping", "numpy", "portbench.reference"]
    assert modules_check.forbidden(dict.fromkeys(mods)) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "sp_orb_slam_tpu", "sp_orb_slam_tpu.ops.nms"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.compare, portbench.checkpoint, "
            "portbench.traffic, portbench.trace, portbench.readers\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sp_orb_slam_tpu', "
            "'sp_orb_slam_tpu_torch')]\n"
            "print(bad)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_prints_nothing_where_it_cannot_run(tmp_path):
    """A checkout of the benchmark alone (no program, no checkpoint), on a
    machine without a card here: a non-zero exit and no result line."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "euroc-bf16-b32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
