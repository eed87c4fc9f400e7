"""Blocking CUDA runtime calls a traced step (stream, device and event
synchronizes, synchronous memcpys) made inside the program's spans."""

from portbench import spans


def read(rec):
    return spans.calls_per_step(rec, spans.SYNCS)
