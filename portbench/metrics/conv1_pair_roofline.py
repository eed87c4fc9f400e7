"""The share (%) of its roofline that conv1_pair reached in the traced steps
(portbench/counts/conv1_pair.py counts its operations and bytes)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "conv1_pair")
