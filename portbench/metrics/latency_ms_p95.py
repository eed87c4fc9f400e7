"""The 95th percentile, in ms, of every window step's latency from its
hand-in to its collect returning (host clock); every frame of a batch has
its step's latency."""

import numpy as np


def read(rec):
    lat = rec["window"]["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
