"""The share (%) of its roofline that nms reached in the traced steps
(portbench/counts/nms.py counts its operations and bytes)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "nms")
