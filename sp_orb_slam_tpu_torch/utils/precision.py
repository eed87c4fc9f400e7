"""Full-float32 switch for the float32 parity paths.

The JAX package passes `precision=HIGHEST` on its float32 frontend and
matcher paths (models/superpoint.py `_conv`, ops/matching.py
`pairwise_dist`), because the TPU's default truncates float32 operands to
bfloat16.  On the card the same hazard is TF32: a float32 matmul is full
float32 by default, but cuDNN runs a float32 convolution in TF32 (about
three decimal digits) unless told otherwise.  `full_f32()` turns both
switches off for the duration of a block and restores them after.

The switches are process-wide, and in the online mode tracking, mapping
and loop closing enter such blocks from their own threads.  So the blocks
are counted: the first to enter turns TF32 off, the last to leave restores
it.  A thread leaving its block never turns TF32 back on under another
thread's float32 work (the frontend's convolutions among them).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0        # blocks open in any thread
_saved = None     # the switches as the first block found them


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions without TF32."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _saved
