"""What the VLAD tools share: the pose-geometry pair classes of the
rendered loop rail (the closed camera loop through a rendered room, as
tests/test_netvlad.py calls it) and the descriptors of its frames.

The JAX package's scripts/fit_vlad_centroids.py:120-129 and
scripts/vlad_rendered_stats.py:69-77 spell out the same classification of
sampled frame pairs by camera pose: revisit (more than 40 frames apart,
centres within 0.6 m, viewing directions within 30 degrees), distinct
(more than 40 frames apart, centres over 2 m apart or facing more than 90
degrees apart) and adjacent (one stride apart at most).

Deliberate difference: `pair_classes` raises when the revisit or the
distinct class is empty.  The JAX scripts then take the median of nothing
(NaN), and the fit's selection keeps its first combination without a word,
since `nan > best` is false.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS = os.path.join(REPO, "weights", "sp_rendered.npz")


class Pairs(NamedTuple):
    """(F, F) bool masks over the sampled frames."""

    revisit: np.ndarray
    distinct: np.ndarray
    adjacent: np.ndarray


def pair_classes(poses, idxs, stride: int) -> Pairs:
    """The pair classes of frames `idxs` (frame numbers) with camera-to-
    world poses `poses` (one (4, 4) each), sampled every `stride` frames."""
    pos = np.stack([p[:3, 3] for p in poses])
    fwd = np.stack([p[:3, :3] @ np.array([0, 0, 1.0]) for p in poses])
    dp = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    dv = (fwd[:, None] * fwd[None, :]).sum(-1)
    sep = np.abs(np.subtract.outer(idxs, idxs))
    far = sep > 40  # temporal neighbours are covisible anyway
    pairs = Pairs(revisit=far & (dp < 0.6) & (dv > np.cos(np.radians(30))),
                  distinct=far & ((dp > 2.0) | (dv < 0.0)),
                  adjacent=(sep > 0) & (sep <= stride))
    for name in ("revisit", "distinct"):
        if not getattr(pairs, name).any():
            raise ValueError(f"no {name} pair among frames {list(idxs)}: "
                             f"sample more of the loop")
    return pairs


def frame_descriptors(run, ds, idxs):
    """(desc (F, K, 256), valid (F, K)) on the extractor's device: frame i
    of the dataset `ds` for each i in `idxs`, each through the extractor
    closure `run` (`extractor.make_extractor`) alone, as the JAX scripts
    extract one frame a call."""
    desc, valid = [], []
    for i in idxs:
        feats = run(ds.frame(i).image[None].astype(np.float32) / 255.0)
        desc.append(feats.desc[0])
        valid.append(feats.valid[0])
    return torch.stack(desc), torch.stack(valid)
