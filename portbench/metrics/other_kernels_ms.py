"""Device ms a traced step of every device event no fragment file claims
and that is no host <-> device copy: the plain PyTorch post-processing
(heads, selection, the readback's packing), device copies and memsets."""

from portbench import readers, trace


def read(rec):
    ms = readers.ms_per_step(rec)
    return None if ms is None else ms.get(trace.OTHER, 0.0)
