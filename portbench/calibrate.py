"""The readings a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,.. \
        --control-seeds 101,102,103 --seconds 2 [--out FILE]

Runs the cell with the program on each of `--seeds` and with the control
(the driver's `ControlProgram`: the plain reference one precision below
the configuration's) on each of `--control-seeds`, each for a short
window at the cell's own size and load, and prints every number of the
comparison for each run, then for each number the largest reading of the
program (the lower reading) and the smallest of the control (the upper
reading).  The benchmark's own runs never run the control.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    c = harness.cell(ROOT, a.workload)
    driver = harness.load_module(ROOT, "drivers", c.traffic["driver"])
    rows = []
    for side, seeds, program in (
            ("program", a.seeds, None),
            ("control", a.control_seeds, driver.ControlProgram)):
        for s in filter(None, seeds.split(",")):
            ctx_seed = int(s)
            res = harness.run_cell(ROOT, a.workload, ctx_seed, a.seconds,
                                   False, program=program,
                                   readings=True)
            row = dict(side=side, seed=ctx_seed, correct=res["correct"],
                       readings=res["readings"],
                       metrics={k: v["value"]
                                for k, v in res["metrics"].items()})
            rows.append(row)
            print(json.dumps(row), flush=True)
    names = sorted({k for r in rows for k in r["readings"]})
    summary = {}
    for k in names:
        lo = [r["readings"][k] for r in rows if r["side"] == "program"]
        hi = [r["readings"][k] for r in rows if r["side"] == "control"]
        summary[k] = dict(lower=max(lo) if lo else None,
                          upper=min(hi) if hi else None)
    print(json.dumps({"summary": summary}), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
