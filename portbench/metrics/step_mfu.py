"""The step's share (%) of the configuration's peak rate: the forward's
direct-convolution operations a frame (`portbench/counts/superpoint.py`)
times the frames of the window over its seconds (host clock)."""

from portbench.harness import load_module


def read(rec):
    w = rec["window"]
    if not w["seconds"]:
        return None
    flops = load_module(rec["root"], "counts",
                        "superpoint").flops_per_frame(rec["config"])
    rate = flops * w["frames"] / w["seconds"]
    return 100.0 * rate / rec["peaks"][rec["config"]["peak"]]
