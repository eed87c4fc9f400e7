"""CUDA graph launches a traced step made inside the program's spans: the
replays of the extraction's captured graph (`sp/extract/replay`), 0 where
every step runs eagerly."""

from portbench import spans


def read(rec):
    return spans.calls_per_step(rec, {"cudaGraphLaunch"})
