"""Device ms a traced step of the conv stack: the kernels whose fragment
files put them in the "conv" layer (cuDNN / cuBLAS convolutions and the
fused first pair)."""

from portbench import readers


def read(rec):
    return readers.layer_ms_per_step(rec, "conv")
