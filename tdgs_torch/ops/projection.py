"""EWA projection of 3D Gaussians to screen space (PyTorch port of
``tdgs/ops/projection.py:241 fully_fused_projection``).

Dense ``[..., C, N]`` outputs; invalid gaussians have ``radii == 0``. The
covariance chain stays in components, so every step is elementwise. Three
camera models: pinhole (perspective), ortho and fisheye (equidistant), each
differentiated by autograd through the same elementwise ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdgs_torch.ops.transforms import (
    covar_cam_sym6,
    pos_world_to_cam,
    quat_scale_to_covar_sym6,
)

# Minimum contribution for a gaussian to be composited (1/255).
ALPHA_THRESHOLD = 1.0 / 255.0


def _cov33_to_sym6(covars):
    return (covars[..., 0, 0], covars[..., 0, 1], covars[..., 0, 2],
            covars[..., 1, 1], covars[..., 1, 2], covars[..., 2, 2])


def _jac_sandwich_2x3(cov6, j00, j01, j02, j10, j11, j12):
    """(c00, c01, c11) of J Σ Jᵀ for a per-element 2x3 Jacobian."""
    s00, s01, s02, s11, s12, s22 = cov6
    a0 = j00 * s00 + j01 * s01 + j02 * s02
    a1 = j00 * s01 + j01 * s11 + j02 * s12
    a2 = j00 * s02 + j01 * s12 + j02 * s22
    b0 = j10 * s00 + j11 * s01 + j12 * s02
    b1 = j10 * s01 + j11 * s11 + j12 * s12
    b2 = j10 * s02 + j11 * s12 + j12 * s22
    c00 = a0 * j00 + a1 * j01 + a2 * j02
    c01 = a0 * j10 + a1 * j11 + a2 * j12
    c11 = b0 * j10 + b1 * j11 + b2 * j12
    return c00, c01, c11


def _stack_cov2d(c00, c01, c11):
    return torch.stack([torch.stack([c00, c01], dim=-1),
                        torch.stack([c01, c11], dim=-1)], dim=-2)


def _persp_proj6(means, cov6, Ks, width: int, height: int):
    """Component-form EWA pinhole projection; the Jacobian is evaluated at
    frustum-clamped (tx, ty) with a 0.3·tan(fov) margin."""
    tx, ty, tz = means[..., 0], means[..., 1], means[..., 2]
    tz = torch.where(tz == 0.0, torch.full_like(tz, 1e-8), tz)
    tz2 = tz * tz

    fx = Ks[..., 0, 0, None]
    fy = Ks[..., 1, 1, None]
    cx = Ks[..., 0, 2, None]
    cy = Ks[..., 1, 2, None]
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy

    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    txc = tz * torch.minimum(torch.maximum(tx / tz, -lim_x_neg), lim_x_pos)
    tyc = tz * torch.minimum(torch.maximum(ty / tz, -lim_y_neg), lim_y_pos)

    j00 = fx / tz
    j02 = -fx * txc / tz2
    j11 = fy / tz
    j12 = -fy * tyc / tz2

    zero = torch.zeros_like(j00)
    cov2d6 = _jac_sandwich_2x3(cov6, j00, zero, j02, zero, j11, j12)
    means2d = torch.stack([fx * tx / tz + cx, fy * ty / tz + cy], dim=-1)
    return means2d, cov2d6


def _ortho_proj6(means, cov6, Ks, width: int, height: int):
    """Component-form orthographic projection: J = diag(fx, fy) on x, y."""
    fx = Ks[..., 0, 0, None]
    fy = Ks[..., 1, 1, None]
    cx = Ks[..., 0, 2, None]
    cy = Ks[..., 1, 2, None]
    zero = torch.zeros_like(fx * means[..., 0])
    cov2d6 = _jac_sandwich_2x3(cov6, fx + zero, zero, zero, zero, fy + zero, zero)
    means2d = torch.stack([means[..., 0] * fx + cx, means[..., 1] * fy + cy], dim=-1)
    return means2d, cov2d6


def _fisheye_proj6(means, cov6, Ks, width: int, height: int):
    """Component-form equidistant fisheye projection: the radius in pixels
    is f·θ, θ the angle to the optical axis. ``eps`` sits where the JAX
    package puts it: in |xy| and x², and in the means' arctan2 denominator
    but not the Jacobian's."""
    x, y, z = means[..., 0], means[..., 1], means[..., 2]
    fx = Ks[..., 0, 0, None]
    fy = Ks[..., 1, 1, None]
    cx = Ks[..., 0, 2, None]
    cy = Ks[..., 1, 2, None]

    eps = 1e-7
    xy_len = torch.sqrt(x * x + y * y) + eps
    theta = torch.atan2(xy_len, z + eps)
    means2d = torch.stack(
        [x * fx * theta / xy_len + cx, y * fy * theta / xy_len + cy], dim=-1)

    x2 = x * x + eps
    y2 = y * y
    xy = x * y
    x2y2 = x2 + y2
    x2y2z2_inv = 1.0 / (x2y2 + z * z)
    b = torch.atan2(xy_len, z) / xy_len / x2y2
    a = z * x2y2z2_inv / x2y2
    j00 = fx * (x2 * a + y2 * b)
    j01 = fx * xy * (a - b)
    j02 = -fx * x * x2y2z2_inv
    j10 = fy * xy * (a - b)
    j11 = fy * (y2 * a + x2 * b)
    j12 = -fy * y * x2y2z2_inv

    cov2d6 = _jac_sandwich_2x3(cov6, j00, j01, j02, j10, j11, j12)
    return means2d, cov2d6


_PROJ6 = {"pinhole": _persp_proj6, "ortho": _ortho_proj6, "fisheye": _fisheye_proj6}


def _proj(camera_model: str):
    proj6 = _PROJ6.get(camera_model)
    if proj6 is None:
        raise ValueError(f"unsupported camera_model {camera_model!r}")
    return proj6


def proj(
    means: torch.Tensor,  # [..., C, N, 3] camera-space means
    covars: torch.Tensor,  # [..., C, N, 3, 3] camera-space covariances
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    camera_model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused projection of camera-space gaussians (``tdgs/ops/
    projection.py:201 proj``) → (means2d [..., C, N, 2], cov2d [..., C, N,
    2, 2])."""
    means2d, (c00, c01, c11) = _proj(camera_model)(
        means, _cov33_to_sym6(covars), Ks, width, height)
    return means2d, _stack_cov2d(c00, c01, c11)


def ortho_proj(means, covars, Ks, width: int, height: int):
    """Orthographic projection (``proj`` with ``camera_model="ortho"``)."""
    return proj(means, covars, Ks, width, height, "ortho")


def fisheye_proj(means, covars, Ks, width: int, height: int):
    """Equidistant fisheye projection (``proj`` with
    ``camera_model="fisheye"``)."""
    return proj(means, covars, Ks, width, height, "fisheye")


def fully_fused_projection(
    means: torch.Tensor,  # [..., N, 3]
    quats: Optional[torch.Tensor],  # [..., N, 4]
    scales: Optional[torch.Tensor],  # [..., N, 3]
    viewmats: torch.Tensor,  # [..., C, 4, 4]
    Ks: torch.Tensor,  # [..., C, 3, 3]
    width: int,
    height: int,
    eps2d: float = 0.3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    camera_model: str = "pinhole",
    opacities: Optional[torch.Tensor] = None,  # [..., N]
    covars: Optional[torch.Tensor] = None,  # [..., N, 3, 3] overrides quats/scales
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """World-space gaussians → screen.

    Returns (radii [..., C, N, 2] int32, means2d [..., C, N, 2],
    depths [..., C, N], conics [..., C, N, 3], compensations or None).
    Culls on blurred det ≤ 0, depth outside (near, far), opacity below
    ALPHA_THRESHOLD, radius ≤ radius_clip on both axes and image bounds.
    The radius extend is min(3.33, sqrt(2·ln(op/αmin))) when opacities are
    given, else 3.33.
    """
    proj6 = _proj(camera_model)
    if covars is None:
        cov6_w = quat_scale_to_covar_sym6(quats, scales)
    else:
        cov6_w = _cov33_to_sym6(covars)
    means_c = pos_world_to_cam(means, viewmats)
    cov6_c = covar_cam_sym6(cov6_w, viewmats)
    means2d, (c00, c01, c11) = proj6(means_c, cov6_c, Ks, width, height)
    depths = means_c[..., 2]

    # low-pass blur + antialiasing compensation
    det_orig = c00 * c11 - c01 * c01
    c00b = c00 + eps2d
    c11b = c11 + eps2d
    det = c00b * c11b - c01 * c01
    compensation = torch.sqrt(
        torch.clamp(det_orig / torch.clamp(det, min=1e-10), min=0.0)
    )

    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    conics = torch.stack([c11b / det_safe, -c01 / det_safe, c00b / det_safe],
                         dim=-1)

    valid = (det > 0.0) & (depths > near_plane) & (depths < far_plane)

    extend = torch.full_like(depths, 3.33)
    if opacities is not None:
        op = opacities[..., None, :] * torch.ones_like(depths)
        if calc_compensations:
            op = op * compensation
        valid = valid & (op >= ALPHA_THRESHOLD)
        op_safe = torch.clamp(op, min=ALPHA_THRESHOLD)
        extend = torch.minimum(
            extend, torch.sqrt(2.0 * torch.log(op_safe / ALPHA_THRESHOLD))
        )

    radius_x = torch.ceil(extend * torch.sqrt(torch.clamp(c00b, min=0.0)))
    radius_y = torch.ceil(extend * torch.sqrt(torch.clamp(c11b, min=0.0)))

    valid = valid & ~((radius_x <= radius_clip) & (radius_y <= radius_clip))
    valid = valid & (
        (means2d[..., 0] + radius_x > 0)
        & (means2d[..., 0] - radius_x < width)
        & (means2d[..., 1] + radius_y > 0)
        & (means2d[..., 1] - radius_y < height)
    )

    radii = torch.where(
        valid[..., None],
        torch.stack([radius_x, radius_y], dim=-1),
        torch.zeros((), dtype=radius_x.dtype, device=radius_x.device),
    ).to(torch.int32)

    if calc_compensations:
        compensations = torch.where(valid, compensation,
                                    torch.zeros_like(compensation))
    else:
        compensations = None
    return radii, means2d, depths, conics, compensations
