"""2DGS (surfel) projection (PyTorch port of
``tdgs/ops/projection_2dgs.py:26 fully_fused_projection_2dgs``).

Builds the ray-space transform M = (K [R·quat_rot·diag(sx, sy) | t])ᵀ per
(camera, gaussian), camera-frame surfel normals turned toward the camera,
and the screen-space extent from the homogeneous centre/extent identities.
The normal is the rotation's unit third axis, t_u × t_v, as the 2DGS paper
and gsplat's CUDA projection take it; the third scale is not read. (The
JAX package scales it by that scale; see ROADMAP, faults on the reference
side.)
As in the JAX package the chain stays in per-component [..., C, N] tensors
and only M is stacked at the end, so every step is elementwise and
differentiable through autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdgs_torch.ops.transforms import quat_to_rotmat_comps


def fully_fused_projection_2dgs(
    means: torch.Tensor,  # [..., N, 3]
    quats: torch.Tensor,  # [..., N, 4]
    scales: torch.Tensor,  # [..., N, 3] (z unused)
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (radii [..., C, N, 2] int32, means2d [..., C, N, 2], depths
    [..., C, N], ray_transforms M [..., C, N, 3, 3], normals [..., C, N, 3])."""
    x = means[..., None, :, 0]
    y = means[..., None, :, 1]
    z = means[..., None, :, 2]
    Wm = [[viewmats[..., i, j, None] for j in range(3)] for i in range(3)]
    t = [viewmats[..., i, 3, None] for i in range(3)]
    mc = [Wm[i][0] * x + Wm[i][1] * y + Wm[i][2] * z + t[i] for i in range(3)]

    # world-frame scaled surfel axes: RS_wl[k][j] = R[k][j] · s_j
    r = quat_to_rotmat_comps(quats)
    s = [scales[..., j] for j in range(2)]
    RS_wl = [[r[3 * k + j] * s[j] for j in range(2)] for k in range(3)]
    # camera-frame tangent axes: RS_cl[i][j] = Σ_k W[i][k] · RS_wl[k][j]
    RS_cl = [[Wm[i][0] * RS_wl[0][j] + Wm[i][1] * RS_wl[1][j] + Wm[i][2] * RS_wl[2][j]
              for j in range(2)] for i in range(3)]

    # surfel normal: the local z axis, unscaled, turned toward the camera
    n_cl = [Wm[i][0] * r[2] + Wm[i][1] * r[5] + Wm[i][2] * r[8] for i in range(3)]
    cos = -(n_cl[0] * mc[0] + n_cl[1] * mc[1] + n_cl[2] * mc[2])
    flip = torch.where(cos > 0, 1.0, -1.0)
    normals = torch.stack([n_cl[i] * flip for i in range(3)], dim=-1)

    # T_sl = K [RS[:, :2] | mean_c]
    fx = Ks[..., 0, 0, None]
    fy = Ks[..., 1, 1, None]
    cx = Ks[..., 0, 2, None]
    cy = Ks[..., 1, 2, None]
    T_cl = [[RS_cl[i][0], RS_cl[i][1], mc[i]] for i in range(3)]
    T_sl = [
        [fx * T_cl[0][j] + cx * T_cl[2][j] for j in range(3)],
        [fy * T_cl[1][j] + cy * T_cl[2][j] for j in range(3)],
        T_cl[2],
    ]
    # M = T_slᵀ: M[i][j] = T_sl[j][i]
    M = torch.stack([torch.stack([T_sl[j][i] for j in range(3)], dim=-1)
                     for i in range(3)], dim=-2)

    # centre and extent: with h = T_sl[2] and test = (1, 1, -1),
    # d = Σ_r h_r² test_r, f_r = test_r / d, means2d_k = Σ_r T_sl[k][r] h_r f_r,
    # extent²_k = means2d_k² − Σ_r T_sl[k][r]² f_r
    h = T_sl[2]
    d = h[0] * h[0] + h[1] * h[1] - h[2] * h[2]
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    big = d.abs() > eps
    f = [torch.where(big, test_r / d_safe, torch.zeros_like(d)) for test_r in (1.0, 1.0, -1.0)]
    m2d = [T_sl[k][0] * h[0] * f[0] + T_sl[k][1] * h[1] * f[1] + T_sl[k][2] * h[2] * f[2]
           for k in range(2)]
    ext = [torch.sqrt(torch.clamp(
        m2d[k] * m2d[k] - (T_sl[k][0] * T_sl[k][0] * f[0] + T_sl[k][1] * T_sl[k][1] * f[1]
                           + T_sl[k][2] * T_sl[k][2] * f[2]), min=1e-4))
        for k in range(2)]
    means2d = torch.stack(m2d, dim=-1)

    depths = mc[2]
    radius_x = torch.ceil(3.33 * ext[0])
    radius_y = torch.ceil(3.33 * ext[1])
    valid = big & (depths > near_plane) & (depths < far_plane)
    valid = valid & ~((radius_x <= radius_clip) & (radius_y <= radius_clip))
    valid = valid & ((m2d[0] + radius_x > 0) & (m2d[0] - radius_x < width)
                     & (m2d[1] + radius_y > 0) & (m2d[1] - radius_y < height))
    radii = torch.where(valid[..., None], torch.stack([radius_x, radius_y], dim=-1),
                        torch.zeros_like(means2d)).detach().to(torch.int32)
    return radii, means2d, depths, M, normals
