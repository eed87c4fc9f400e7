"""Host ms a traced step inside the program's own spans of a hand-in: the
extraction's (`sp/extract`, with its upload) and the init match's
(`sp/match/init`). The in-program twin of `host_enqueue_ms`."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "sp/extract", "sp/match/init")
