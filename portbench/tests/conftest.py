"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

Tests that need a CUDA card carry the `gpu` marker and skip without one
(decided in the `cuda` fixture, never at import); run them on the card
with `python -m pytest portbench/tests -q -m gpu`.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the benchmark's chip tests)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


TINY_CAMERA = dict(width=160, height=120, fx=76.0, fy=89.0, cx=80.0, cy=60.0)
TINY_TRAFFIC = dict(driver="frontend_step", streams=2, frames=3,
                    trajectory_frames=220, in_flight=2, warmup_steps=2,
                    profile_steps=3, check_frames=8)


def make_root(base, cells=(("tiny-f32", "sp-euroc-f32"),
                           ("tiny-bf16", "sp-euroc-bf16"))):
    """A checkout-like root under `base`: BENCHMARK.json and portbench/
    copied (tests left out), the committed checkpoint linked, and one tiny
    cell (160x120, 2 streams, 3 frames) for each (cell, configuration)
    with the configuration's own limits taken from its first cell."""
    import json
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(base, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.makedirs(os.path.join(base, "weights"))
    os.symlink(os.path.join(ROOT, "weights", "sp_rendered.npz"),
               os.path.join(base, "weights", "sp_rendered.npz"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(base, "portbench")
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    for name, conf in cells:
        with open(os.path.join(pb, "configs", f"{conf}.json")) as f:
            cfg = json.load(f)
        cfg.update(name=f"{name}-config", camera=TINY_CAMERA)
        with open(os.path.join(pb, "configs", f"{name}-config.json"),
                  "w") as f:
            json.dump(cfg, f)
        first = next(w["name"] for w in bench["workloads"]
                     if w["config"] == conf)
        shutil.copy(os.path.join(pb, "workloads", f"{first}.json"),
                    os.path.join(pb, "workloads", f"{name}.json"))
        bench["configs"].append(dict(
            name=f"{name}-config", source="test", reduced=[], why="test",
            file=f"portbench/configs/{name}-config.json"))
        bench["workloads"].append(dict(
            name=name, config=f"{name}-config", traffic="tiny", chips=1,
            why="test"))
    with open(os.path.join(base, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(base)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))
