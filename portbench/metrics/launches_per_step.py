"""Device events (kernels, memcpys, memsets) a traced step."""

from portbench import readers


def read(rec):
    p = readers.profile(rec)
    return len(p["device"]) / p["steps"] if p else None
