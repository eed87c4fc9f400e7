"""The share (%) of its roofline that init_match reached in the traced steps
(portbench/counts/init_match.py counts its operations and bytes)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "init_match")
