"""Host ms a traced step inside the program's upload of the images
(`sp/extract/upload`): the host -> device copy and any wait it makes."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "sp/extract/upload")
