"""The share (%) of its roofline that desc_sample reached in the traced steps
(portbench/counts/desc_sample.py counts its operations and bytes)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "desc_sample")
