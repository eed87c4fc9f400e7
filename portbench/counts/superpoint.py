"""The SuperPoint forward's operations a frame, by direct convolution.

Each layer of the configuration's `layers` ([name, in, out, k]) costs
2 x in x out x k^2 operations at each output pixel; the encoder's pairs
run at full, half and quarter resolution, the fourth pair and both heads
at an eighth.  At 752x480 that is 61.22 GFLOP a frame.
"""

SCALE = {"conv1": 1, "conv2": 2, "conv3": 4, "conv4": 8, "convP": 8,
         "convD": 8}


def flops_per_frame(config: dict) -> float:
    H, W = config["camera"]["height"], config["camera"]["width"]
    total = 0.0
    for name, cin, cout, k in config["layers"]:
        s = SCALE[name[:5]]
        total += 2.0 * (H // s) * (W // s) * cin * cout * k * k
    return total
