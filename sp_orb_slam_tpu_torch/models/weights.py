"""Checkpoint loading for the SuperPoint frontend.

The port's state is a PyTorch state dict with the reference's layer names
(`conv1a.weight` OIHW, `conv1a.bias`, ... as registered by
src/cv/sp_extractor.cpp:46-63 and the magicleap SuperPointNet layout), read
from either

- a numpy .npz with keys "<layer>.weight" / "<layer>.bias" (e.g. the
  committed weights/sp_rendered.npz), or
- a torch .pt/.pth: a state dict, a pickled module or a torchscript archive.

`params_from_jax` converts the JAX package's parameter pytree
{name: {w: HWIO, b}} into the same state dict and `params_to_jax` back;
`save_npz` writes a state dict as the .npz interchange file that both
packages' `load_checkpoint` read.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sp_orb_slam_tpu_torch.models.superpoint import LAYERS


def _convert_state_dict(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, cin, cout, k in LAYERS:
        for prefix in (name, f"module.{name}", f"model.{name}"):
            if f"{prefix}.weight" in state:
                w = state[f"{prefix}.weight"]
                b = state[f"{prefix}.bias"]
                break
        else:
            raise KeyError(f"checkpoint missing layer {name!r}")
        w = torch.as_tensor(np.array(w, dtype=np.float32, order="C"))
        if tuple(w.shape) != (cout, cin, k, k):
            raise ValueError(f"{name}: expected {(cout, cin, k, k)}, "
                             f"got {tuple(w.shape)}")
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = torch.as_tensor(
            np.array(b, dtype=np.float32, order="C"))
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a SuperPoint checkpoint (.npz/.pt/.pth) as a float32 state dict
    on the CPU."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return _convert_state_dict({k: z[k] for k in z.files})
    try:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:  # torchscript archive ("please use torch.jit.load")
        blob = torch.jit.load(path, map_location="cpu")
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    return _convert_state_dict(
        {k: v.detach().cpu().numpy() for k, v in blob.items()})


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's {name: {"w": (kh, kw, cin, cout), "b": (cout,)}}
    parameters (numpy or any array with __array__) -> the port's state
    dict."""
    return _convert_state_dict({
        **{f"{n}.weight": np.transpose(np.asarray(p["w"], np.float32),
                                       (3, 2, 0, 1))
           for n, p in params.items()},
        **{f"{n}.bias": np.asarray(p["b"], np.float32)
           for n, p in params.items()}})


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the JAX package's parameters
    {name: {"w": (kh, kw, cin, cout), "b": (cout,)}} as float32 numpy
    copies."""
    def arr(t):
        return np.array(t.detach().cpu(), np.float32)

    return {name: {"w": arr(state[f"{name}.weight"]).transpose(2, 3, 1, 0),
                   "b": arr(state[f"{name}.bias"])}
            for name, *_ in LAYERS}


def save_npz(state: Dict[str, torch.Tensor], path: str) -> None:
    """Write a state dict as the .npz interchange format: keys
    "<layer>.weight" (OIHW) and "<layer>.bias", float32 (the JAX package's
    models/weights.py `save_npz` writes the same file from its
    parameters)."""
    np.savez(path, **{
        f"{name}.{key}": np.array(state[f"{name}.{key}"].detach().cpu(),
                                  np.float32)
        for name, *_ in LAYERS for key in ("weight", "bias")})
