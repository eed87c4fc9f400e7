"""Host ms a traced step inside the program's feature readback
(`sp/readback`: the pack, the device -> host copy and its wait, the
unpack into host mirrors)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "sp/readback")
