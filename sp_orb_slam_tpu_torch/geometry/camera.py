"""Pinhole camera: projection, frustum checks, undistortion/rectification.

The port of the JAX package's geometry/camera.py: projection u = fx x/z + cx;
rectification of a distorted stream as a precomputed sampling grid
(cv::initUndistortRectifyMap with R = I, radial-tangential model) plus one
bilinear remap; iterative point undistortion (cv::undistortPoints).
`K` is the 4-vector [fx, fy, cx, cy] throughout.
"""

from __future__ import annotations

import torch


def project(K: torch.Tensor, pts_cam: torch.Tensor, eps: float = 1e-9):
    """Project camera-frame points (..., 3) -> pixels (..., 2) and depth."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < eps, eps, z)
    u = K[0] * pts_cam[..., 0] * inv_z + K[2]
    v = K[1] * pts_cam[..., 1] * inv_z + K[3]
    return torch.stack([u, v], -1), z


def back_project(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) -> unit-depth camera ray (..., 3)."""
    x = (uv[..., 0] - K[2]) / K[0]
    y = (uv[..., 1] - K[3]) / K[1]
    return torch.stack([x, y, torch.ones_like(x)], -1)


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The radial-tangential (plumb-bob) model on normalized coordinates,
    dist = [k1, k2, p1, p2, k3]."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x_d, y_d], -1)


def rectify_map(K_new: torch.Tensor, K_raw: torch.Tensor, dist: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
    """The (H, W, 2) raw-image sampling grid of the rectification: for every
    rectified pixel, unproject with K_new, distort, reproject with K_raw."""
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=K_new.device),
        torch.arange(width, dtype=torch.float32, device=K_new.device),
        indexing="ij")
    xy = back_project(K_new, torch.stack([u, v], -1))[..., :2]
    xy_d = distort_normalized(xy, dist)
    return torch.stack([xy_d[..., 0] * K_raw[0] + K_raw[2],
                        xy_d[..., 1] * K_raw[1] + K_raw[3]], -1)


def bilinear_remap(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `image` (..., H, W) at `grid` (..., 2) of (u, v) pixel coords;
    out-of-bounds samples clamp to the border."""
    H, W = image.shape[-2], image.shape[-1]
    u = grid[..., 0].clamp(0.0, W - 1.000001)
    v = grid[..., 1].clamp(0.0, H - 1.000001)
    u0 = u.floor().long()
    v0 = v.floor().long()
    du = u - u0
    dv = v - v0
    u1 = (u0 + 1).clamp(max=W - 1)
    v1 = (v0 + 1).clamp(max=H - 1)
    i00 = image[..., v0, u0]
    i01 = image[..., v0, u1]
    i10 = image[..., v1, u0]
    i11 = image[..., v1, u1]
    return ((1 - du) * (1 - dv) * i00 + du * (1 - dv) * i01
            + (1 - du) * dv * i10 + du * dv * i11)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 5) -> torch.Tensor:
    """Invert the distortion model by the fixed point
    xy <- xy_d - (distort(xy) - xy)."""
    xy_d = back_project(K, uv)[..., :2]
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort_normalized(xy, dist) - xy)
    return torch.stack([xy[..., 0] * K[0] + K[2],
                        xy[..., 1] * K[1] + K[3]], -1)


def in_frustum(Tcw: torch.Tensor, K: torch.Tensor, pts_w: torch.Tensor,
               bounds: torch.Tensor, normals: torch.Tensor,
               min_dist: torch.Tensor, max_dist: torch.Tensor,
               view_cos_limit: float):
    """Batched Frame::isInFrustum.  pts_w (N, 3), normals (N, 3), min/max
    distances (N,), bounds = [minX, maxX, minY, maxY].  Returns (visible,
    uv, depth, view_cos, dist)."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    uv, z = project(K, pts_w @ R.T + t)
    po = pts_w - (-R.T @ t)
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = (po * normals).sum(-1) / dist.clamp_min(1e-9)
    ok = ((z > 0)
          & (uv[..., 0] >= bounds[0]) & (uv[..., 0] <= bounds[1])
          & (uv[..., 1] >= bounds[2]) & (uv[..., 1] <= bounds[3])
          & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos >= view_cos_limit))
    return ok, uv, z, view_cos, dist
