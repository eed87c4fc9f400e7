"""SO(3)/SE(3) operations as batched PyTorch functions.

The port of the JAX package's geometry/se3.py.  Poses are 4x4 row-major
matrices `Tcw` (world -> camera) and tangent increments follow g2o's
SE3Quat::exp ordering: xi = [omega(3), upsilon(3)] with the
left-multiplicative update T <- exp(xi) * T.  Every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye3(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3), safe at theta -> 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), atan2/series form (finite near identity)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    cos_t = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    s2 = (vee * vee).sum(-1) * 0.25  # sin^2(theta)
    small = s2 < 1e-10
    # a tensor branch: under torch.func.jacfwd a number gives a float64
    # tangent
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, 0.5 + s2 / 12.0, theta / (2.0 * sin_t))
    return scale[..., None] * vee


def _V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3) (the 'V' matrix of the SE(3) exp)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from a rotation block (..., 3, 3) and translation (..., 3)."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """g2o-ordered tangent [omega, upsilon] (..., 6) -> (..., 4, 4)."""
    w, u = xi[..., :3], xi[..., 3:]
    return _rt(so3_exp(w), (_V(w) @ u[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> [omega, upsilon] (..., 6)."""
    w = so3_log(T[..., :3, :3])
    Vinv, _ = torch.linalg.inv_ex(_V(w))
    u = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, u], -1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def se3_apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if x.dim() == T.dim() - 1:  # (..., N, 3)
        return x @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ x[..., None])[..., 0] + t


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """twc = -Rcw^T tcw."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3:]
    return (-R.transpose(-1, -2) @ t)[..., 0]


def sim3_matrix(R: torch.Tensor, t: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) Sim3 with the scaled rotation block sR."""
    return _rt(R * s[..., None, None], t)


def sim3_inv(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_apply(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Apply s*R*x + t to points (..., 3) / (..., N, 3)."""
    if x.dim() == R.dim() - 1:  # batch of points
        return (s[..., None, None] * (x @ R.transpose(-1, -2))
                + t[..., None, :])
    return s[..., None] * (R @ x[..., None])[..., 0] + t
