"""Device ms a traced step of host <-> device copies (memcpy HtoD and
DtoH): the images' upload and the readback of the host mirrors and
matches."""

from portbench import readers, trace


def read(rec):
    ms = readers.ms_per_step(rec)
    return None if ms is None else ms.get(trace.TRANSFER, 0.0)
