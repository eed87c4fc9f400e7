"""The share (%) of its roofline that cov reached in the traced steps
(portbench/counts/cov.py counts its operations and bytes)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "cov")
