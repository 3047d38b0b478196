"""Depth-map geometry (PyTorch port of ``tdgs/utils/depth.py``):
``depth_to_points``, ``depth_to_normal``, ``log_transform`` and its
inverse, ``get_projection_matrix``.

The rotations are elementwise products and sums (``rotate``), not matrix
products, so they stay in true float32 whatever ``matmul.allow_tf32`` says.
"""

from __future__ import annotations

import math

import torch


def log_transform(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(torch.abs(y))


def rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] applied to the vectors v [..., H, W, 3] of each image,
    in true float32."""
    return (R[..., None, None, :, :] * v[..., None, :]).sum(-1)


def depth_to_points(
    depths: torch.Tensor,  # [..., H, W, 1] z-depth
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
) -> torch.Tensor:
    """Unproject a z-depth map to world-space points [..., H, W, 3]."""
    H, W = depths.shape[-3:-1]
    x = torch.arange(W, dtype=depths.dtype, device=depths.device) + 0.5
    y = torch.arange(H, dtype=depths.dtype, device=depths.device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    fx = Ks[..., 0, 0][..., None, None]
    fy = Ks[..., 1, 1][..., None, None]
    cx = Ks[..., 0, 2][..., None, None]
    cy = Ks[..., 1, 2][..., None, None]
    z = depths[..., 0]
    px = (xx - cx) / fx * z
    py = (yy - cy) / fy * z
    pts_c = torch.stack([px, py, z], dim=-1)  # [..., H, W, 3]
    R = camtoworlds[..., :3, :3]
    t = camtoworlds[..., :3, 3]
    return rotate(R, pts_c) + t[..., None, None, :]


def depth_to_normal(
    depths: torch.Tensor,  # [..., H, W, 1]
    camtoworlds: torch.Tensor,  # [..., 4, 4]
    Ks: torch.Tensor,  # [..., 3, 3]
) -> torch.Tensor:
    """Screen-space finite-difference normals of a depth map (world frame,
    zero on the 1-pixel border) [..., H, W, 3]."""
    pts = depth_to_points(depths, camtoworlds, Ks)
    dx = pts[..., 2:, 1:-1, :] - pts[..., :-2, 1:-1, :]
    dy = pts[..., 1:-1, 2:, :] - pts[..., 1:-1, :-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # n · rsqrt(Σn² + ε): a norm has a NaN gradient at exactly 0, which flat
    # depth regions and the zero border give
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                          device=None) -> torch.Tensor:
    """OpenGL-style projection matrix."""
    t = znear * math.tan(0.5 * fovy)
    b = -t
    r = znear * math.tan(0.5 * fovx)
    left = -r
    return torch.tensor([
        [2 * znear / (r - left), 0.0, (r + left) / (r - left), 0.0],
        [0.0, 2 * znear / (t - b), (t + b) / (t - b), 0.0],
        [0.0, 0.0, zfar / (zfar - znear), -(zfar * znear) / (zfar - znear)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=torch.float32, device=device)
