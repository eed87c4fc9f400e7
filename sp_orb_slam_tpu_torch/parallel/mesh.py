"""Scale-out: data-parallel stream batching over a mesh of device slots.

The port of the JAX package's parallel/mesh.py.  The reference is one
process on one GPU; the scaling axis here is throughput: many independent
camera streams batched through the extractor, the init matcher and the
pose solve.  A `Mesh` is an ordered tuple of device slots on the "stream"
axis.  A batch of streams is split into `mesh.size` contiguous chunks (the
JAX package shards the leading axis the same way); each chunk runs on its
slot's device with a replica of the weights, and the outputs come back in
stream order on the first slot's device.  No collective is needed: the
streams are independent.

A slot may name a device more than once.  `Mesh(["cuda:0", "cuda:0"])`
splits a batch exactly as two cards would and runs the chunks one after
another on one card; `make_mesh(n, "cpu")` gives n CPU slots, the
counterpart of the JAX package's virtual CPU devices.  Unlike the JAX
package's `make_mesh`, which falls back to the CPU devices when the
accelerator has too few, `make_mesh` here raises: a fallback would hide
the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from sp_orb_slam_tpu_torch.extractor import extract
from sp_orb_slam_tpu_torch.models.superpoint import SuperPoint
from sp_orb_slam_tpu_torch.ops import cuda_match
from sp_orb_slam_tpu_torch.optim import pose as pose_opt
from sp_orb_slam_tpu_torch.utils.precision import full_f32


def _slot(d) -> torch.device:
    """A slot's device with its index ("cuda" is the current card), so
    that slots naming one card compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", idx)
    return d


class Mesh:
    """An ordered 1-D mesh of device slots on the "stream" axis."""

    axis_names = ("stream",)

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(map(_slot, devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device slot")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The slots' devices, each once, in slot order."""
        return list(dict.fromkeys(self.devices))

    def split(self, n: int) -> List[Tuple[torch.device, int, int]]:
        """(device, lo, hi) of each slot's contiguous chunk of `n` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"mesh slots")
        c = n // self.size
        return [(d, i * c, (i + 1) * c) for i, d in enumerate(self.devices)]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """A 1-D stream mesh: the first `n_devices` cards (default: all of
    them), raising ValueError when fewer exist; or, with device_type
    "cpu", `n_devices` CPU slots (default 1)."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_devices}")
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices if n_devices is not None else max(have, 1)
        if have < n:
            raise ValueError(f"need {n} CUDA device(s), have {have}; the "
                             f"CPU slots are make_mesh(n, 'cpu')")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    raise ValueError(f"unknown device_type {device_type!r}")


def gather(parts: list, device: torch.device):
    """Per-chunk outputs (tensors, or tuples / NamedTuples of tensors and
    None) concatenated along the stream axis on `device`; a lone chunk is
    returned as it is (moved to `device`), with no copy."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        if len(parts) == 1:
            return first.to(device)
        return torch.cat([p.to(device) for p in parts])
    fields = [gather(list(f), device) for f in zip(*parts)]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def _solve_one(Tcw0, uv, cov2_inv, m12, Xw_prev, prev_ok, K_intr):
    # m12 maps each previous keypoint to a current one; Xw_prev holds the
    # 3D point behind each previous keypoint
    j = m12.clamp_min(0).long()
    has = (m12 >= 0) & prev_ok
    res = pose_opt.pose_optimization(Tcw0, Xw_prev, uv[j], cov2_inv[j], has,
                                     K_intr, rounds=2, iters=5)
    return res.Tcw, res.n_inlier


def multi_stream_step(model: SuperPoint, images, prev_desc, prev_uv,
                      prev_valid, Tcw_pred, mp_pos, mp_valid, K_intr, *,
                      num_features: int, max_keypoints: int,
                      compute_dtype=torch.bfloat16):
    """One per-stream VO step batched over streams, on the model's device:
    extraction -> the init matcher against the previous frame (window 100,
    ratio 0.9) -> the pose-only solve (2 rounds of 5 iterations).  The unit
    `build_sharded_step` splits over a mesh.  Returns (Features, match12,
    n_matches, Tcw, n_inlier)."""
    with torch.inference_mode():
        feats = extract(model, images, num_features=num_features,
                        max_keypoints=max_keypoints,
                        compute_dtype=compute_dtype)
        match12, n_matches, _ = cuda_match.match_init_batch(
            prev_desc, prev_valid, prev_uv, feats.desc, feats.uv,
            feats.valid, window=100, ratio=0.9)
        with full_f32():
            Tcw, n_inlier = torch.func.vmap(
                lambda *a: _solve_one(*a, K_intr))(
                    Tcw_pred, feats.uv, feats.cov2_inv, match12, mp_pos,
                    mp_valid)
    return feats, match12, n_matches, Tcw, n_inlier


def build_sharded_step(mesh: Optional[Mesh], params, *, num_features: int,
                       max_keypoints: int, compute_dtype=torch.bfloat16):
    """`multi_stream_step` split over `mesh` (default: every card, which
    raises without one): the stream axis of each call is cut into
    `mesh.size` contiguous chunks, each run on its slot's device with that
    device's replica of `params` (a state dict, models/weights.py; one
    replica per distinct device), and the outputs are concatenated in
    stream order on the first slot's device.  The batch must split evenly.

    Returns step(images, prev_desc, prev_uv, prev_valid, Tcw_pred, mp_pos,
    mp_valid, K_intr); its arguments may be tensors on any device or numpy
    arrays, with the streams on the leading axis (K_intr is shared)."""
    mesh = mesh if mesh is not None else make_mesh()
    models = {}
    for d in mesh.distinct():
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; a mesh of CPU "
                               "slots is make_mesh(n, 'cpu')")
        models[d] = SuperPoint(params).to(d).eval()

    def step(images, prev_desc, prev_uv, prev_valid, Tcw_pred, mp_pos,
             mp_valid, K_intr):
        batch = (images, prev_desc, prev_uv, prev_valid, Tcw_pred, mp_pos,
                 mp_valid)
        outs = []
        for d, lo, hi in mesh.split(len(images)):
            chunk = [torch.as_tensor(a[lo:hi]).to(d).contiguous()
                     for a in batch]
            outs.append(multi_stream_step(
                models[d], *chunk, torch.as_tensor(K_intr).to(d),
                num_features=num_features, max_keypoints=max_keypoints,
                compute_dtype=compute_dtype))
        return gather(outs, mesh.devices[0])

    return step
