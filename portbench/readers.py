"""What the metric readers (`portbench/metrics/<name>.py`) share: a run's
record and the per-step sums taken from its traced sub-window.

A record (`rec`) holds the run's host-clock window (`window`: seconds,
steps, frames, each step's latency and hand-in seconds), `setup_s`,
`memory`, and with `--trace 1` the `profile` of the traced sub-window
(`seconds`, `steps`, `frames`, the `device` and `host` events, the
`inputs` of each traced step), besides the cell's `config`, `traffic`,
`peaks` and the kernel-name `functions`.  A reader returns None where it
finds nothing to read.
"""

from __future__ import annotations

from portbench import trace


def profile(rec: dict):
    p = rec.get("profile")
    return p if p and p["steps"] else None


def ms_per_step(rec: dict) -> dict | None:
    """Device ms a traced step by what ran: each function, trace.TRANSFER
    (host <-> device copies) and trace.OTHER (every other event)."""
    p = profile(rec)
    if p is None:
        return None
    by = trace.seconds_by(p["device"], rec["functions"])
    return {k: s * 1e3 / p["steps"] for k, s in by.items()}


def layer_ms_per_step(rec: dict, layer: str) -> float | None:
    """Device ms a traced step of the functions of one layer."""
    ms = ms_per_step(rec)
    if ms is None:
        return None
    fns = rec["functions"]
    return sum(v for k, v in ms.items()
               if k in fns and fns[k]["layer"] == layer)


def roofline(rec: dict, function: str) -> float | None:
    """The function's share (%) of its roofline over the traced steps: the
    least time the chip could take for their inputs (the larger of
    operations over the peak rate and bytes over the HBM rate, from
    `portbench/counts/<function>.py`) over the device time of the
    function's kernels.  None where none of its kernels ran."""
    p = profile(rec)
    if p is None:
        return None
    spent = trace.seconds_by(p["device"], rec["functions"]).get(function, 0)
    if spent <= 0:
        return None
    from portbench.harness import load_module

    counts = load_module(rec["root"], "counts", function)
    peaks = rec["peaks"]
    bound = 0.0
    for x in p["inputs"]:
        c = counts.count(x, rec["config"])
        bound += max(c["flops"] / peaks[c["peak"]],
                     c["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / spent
