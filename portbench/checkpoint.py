"""The benchmark's own checkpoint loader: a SuperPoint .npz (keys
"<layer>.weight" OIHW and "<layer>.bias", float32), checked against the
sha256 that the configuration file pins, so that a changed file fails the
run instead of moving the yardstick."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from portbench.reference.superpoint import LAYERS


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load(root: str, weights: dict) -> dict[str, np.ndarray]:
    """{"conv1a.weight": (64, 1, 3, 3) float32, ...} from the file that
    `weights` names (relative to the checkout's root), whose sha256 must be
    `weights["sha256"]`."""
    path = os.path.join(root, weights["file"])
    got = sha256(path)
    if got != weights["sha256"]:
        raise ValueError(f"{weights['file']}: sha256 {got}, the "
                         f"configuration pins {weights['sha256']}")
    out = {}
    with np.load(path) as z:
        for name, cin, cout, k in LAYERS:
            w = np.asarray(z[f"{name}.weight"], np.float32)
            b = np.asarray(z[f"{name}.bias"], np.float32)
            if w.shape != (cout, cin, k, k) or b.shape != (cout,):
                raise ValueError(f"{name}: shapes {w.shape}, {b.shape}, "
                                 f"expected {(cout, cin, k, k)}, {(cout,)}")
            out[f"{name}.weight"], out[f"{name}.bias"] = w, b
    return out
