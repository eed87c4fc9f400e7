"""Seconds from the start of the run to the start of the window: imports,
the checkpoint, rendering the traffic, building the program, loading or
building its kernels, and the warm-up steps."""


def read(rec):
    return rec["setup_s"]
