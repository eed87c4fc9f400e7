"""The device's idle share (%) of the traced sub-window: 1 - the union of
its device events over the sub-window's wall seconds."""

from portbench import readers, trace


def read(rec):
    p = readers.profile(rec)
    if p is None or not p["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(p["device"]) / p["seconds"])
