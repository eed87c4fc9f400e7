"""Device idle ms a traced step while the host is inside the program's
upload of the images (`sp/extract/upload`)."""

from portbench import spans


def read(rec):
    return spans.idle_ms_per_step(rec, "sp/extract/upload")
