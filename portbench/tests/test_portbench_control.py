"""The control must come out not correct: the plain reference put in the
program's place, one precision below the configuration's (float8 e4m3
convolutions for bfloat16, TF32 for float32, the matcher's dot products
in TF32), at each cell's own size and load, on three seeds.  Needs the
card: `python -m pytest portbench/tests -q -m gpu -k control`."""

import json
import os

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda, cell):
    c = harness.cell(ROOT, cell)
    control = harness.load_module(ROOT, "drivers",
                                  c.traffic["driver"]).ControlProgram
    for seed in (2 ** 31 + 101, 2 ** 33 + 202, 303):
        res = harness.run_cell(ROOT, cell, seed, 2.0, False, device=cuda,
                               program=control)
        failed = [k for k, v in res["checks"].items()
                  if v["value"] > v["limit"]]
        assert not res["correct"] and failed, res["checks"]
