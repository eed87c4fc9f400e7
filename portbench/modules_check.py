"""The check that nothing of JAX or of the JAX package was loaded.

A module is forbidden when its top-level name (the part before the first
dot) is, whole, one of FORBIDDEN: `sp_orb_slam_tpu_torch` (the port) shares
the JAX package's prefix and passes.
"""

from __future__ import annotations

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "sp_orb_slam_tpu"))


def forbidden(modules) -> list[str]:
    """The loaded module names (keys of `modules`) whose top-level name is
    forbidden, sorted."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
