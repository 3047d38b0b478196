"""Unscented-transform projection (port of ``tdgs/ops/projection_ut.py``,
3DGUT).

In place of the EWA Jacobian, the 2n + 1 = 7 sigma points of each 3D
gaussian go through the full nonlinear camera model (``camera_models``:
distortion, FTheta, rolling shutter with iterated shutter-time pose
interpolation) and the 2D moments are fitted again. The matrix square root
of Σ is R·S from the quaternion and scales. Plain tensor ops: autograd
differentiates it when it feeds a screen-space rasterizer; under eval3d it
only feeds the tiling.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch.ops.camera_models import (
    FThetaCameraDistortionParameters,
    RollingShutterType,
    interpolate_pose,
    project_point,
    shutter_time_from_pixel,
)
from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.transforms import quat_to_rotmat


class UnscentedTransformParameters(NamedTuple):
    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0
    in_image_margin_factor: float = 0.1
    require_all_sigma_points_valid: bool = False


def _per_camera(coeffs):
    """[..., C, k] camera coefficients → [..., C, 1, 1, k] against the
    [..., C, N, 7] sigma points."""
    return None if coeffs is None else coeffs[..., :, None, None, :]


def fully_fused_projection_with_ut(
    means: torch.Tensor,  # [..., N, 3]
    quats: torch.Tensor,  # [..., N, 4]
    scales: torch.Tensor,  # [..., N, 3]
    opacities: Optional[torch.Tensor],  # [..., N]
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
    ut_params: UnscentedTransformParameters = UnscentedTransformParameters(),
    radial_coeffs: Optional[torch.Tensor] = None,  # [..., C, 6] or [..., C, 4]
    tangential_coeffs: Optional[torch.Tensor] = None,  # [..., C, 2]
    thin_prism_coeffs: Optional[torch.Tensor] = None,  # [..., C, 4]
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[torch.Tensor] = None,  # [..., C, 4, 4] frame end
    rs_iterations: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """UT projection with distortion and rolling shutter. Returns (radii
    [..., C, N, 2] int32, means2d, depths, conics, compensations or None),
    the contract of ``projection.fully_fused_projection``."""
    n_dim = 3
    a, b, k = ut_params.alpha, ut_params.beta, ut_params.kappa
    lam = a * a * (n_dim + k) - n_dim
    w_mean_0 = lam / (n_dim + lam)
    w_cov_0 = w_mean_0 + (1.0 - a * a + b)
    w_i = 1.0 / (2.0 * (n_dim + lam))

    # sigma points in world space: μ and μ ± sqrt(n + λ)·(R·S)ᵢ
    L = quat_to_rotmat(quats) * scales[..., None, :] * (n_dim + lam) ** 0.5
    Lt = L.transpose(-1, -2)  # rows: the scaled axes
    deltas = torch.cat([torch.zeros_like(means)[..., None, :], Lt, -Lt], dim=-2)
    sigma_pts = means[..., None, :] + deltas  # [..., N, 7, 3]

    # world → camera for every (camera, gaussian, sigma point)
    R_cw = viewmats[..., :3, :3]
    t_cw = viewmats[..., :3, 3]
    pts_cam = (torch.einsum("...cij,...nsj->...cnsi", R_cw, sigma_pts)
               + t_cw[..., :, None, None, :])  # [..., C, N, 7, 3]
    Ks_b = Ks[..., :, None, None, :, :]
    coeffs = dict(radial_coeffs=_per_camera(radial_coeffs),
                  tangential_coeffs=_per_camera(tangential_coeffs),
                  thin_prism_coeffs=_per_camera(thin_prism_coeffs),
                  ftheta_coeffs=ftheta_coeffs)
    pixels, valid_pts = project_point(pts_cam, Ks_b, camera_model, **coeffs)

    # rolling shutter: project again from the pose at each point's shutter time
    if rolling_shutter != RollingShutterType.GLOBAL and viewmats_rs is not None:
        for _ in range(rs_iterations):
            t_shutter = shutter_time_from_pixel(pixels, width, height, rolling_shutter)
            vm_t = interpolate_pose(viewmats[..., :, None, None, :, :],
                                    viewmats_rs[..., :, None, None, :, :], t_shutter)
            pts_cam = (torch.einsum("...cnsij,...nsj->...cnsi", vm_t[..., :3, :3], sigma_pts)
                       + vm_t[..., :3, 3])
            pixels, valid_pts = project_point(pts_cam, Ks_b, camera_model, **coeffs)

    # the UT moments; the weights are made on the device (a Python number
    # written into a device tensor is a copy the host waits for)
    first = torch.arange(2 * n_dim + 1, device=means.device) == 0
    w_mean = torch.where(first, w_mean_0, w_i).to(means.dtype)
    w_cov = torch.where(first, w_cov_0, w_i).to(means.dtype)
    mean2d = torch.einsum("s,...sd->...d", w_mean, pixels)  # [..., C, N, 2]
    d = pixels - mean2d[..., None, :]
    cov2d = torch.einsum("s,...sd,...se->...de", w_cov, d, d)
    depths = pts_cam[..., 0, 2]  # the centre point's depth

    c00, c01, c10, c11 = cov2d[..., 0, 0], cov2d[..., 0, 1], cov2d[..., 1, 0], cov2d[..., 1, 1]
    det_orig = c00 * c11 - c01 * c10
    c00b, c11b = c00 + eps2d, c11 + eps2d
    det = c00b * c11b - c01 * c10
    compensation = torch.sqrt(torch.clamp(det_orig / torch.clamp(det, min=1e-10), min=0.0))
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    conics = torch.stack([c11b / det_safe, -c01 / det_safe, c00b / det_safe], dim=-1)

    if ut_params.require_all_sigma_points_valid:
        pts_ok = valid_pts.all(dim=-1)
    else:
        pts_ok = valid_pts.any(dim=-1)
    valid = pts_ok & (det > 0) & (depths > near_plane) & (depths < far_plane)

    extend = torch.full_like(depths, 3.33)
    if opacities is not None:
        op = opacities[..., None, :] * torch.ones_like(depths)
        if calc_compensations:
            op = op * compensation
        valid = valid & (op >= ALPHA_THRESHOLD)
        extend = torch.minimum(extend, torch.sqrt(
            2.0 * torch.log(torch.clamp(op, min=ALPHA_THRESHOLD) / ALPHA_THRESHOLD)))
    radius_x = torch.ceil(extend * torch.sqrt(torch.clamp(c00b, min=0.0)))
    radius_y = torch.ceil(extend * torch.sqrt(torch.clamp(c11b, min=0.0)))
    valid = valid & ~((radius_x <= radius_clip) & (radius_y <= radius_clip))
    margin_x = ut_params.in_image_margin_factor * width
    margin_y = ut_params.in_image_margin_factor * height
    valid = valid & (
        (mean2d[..., 0] + radius_x > -margin_x)
        & (mean2d[..., 0] - radius_x < width + margin_x)
        & (mean2d[..., 1] + radius_y > -margin_y)
        & (mean2d[..., 1] - radius_y < height + margin_y)
    )
    radii = torch.where(valid[..., None], torch.stack([radius_x, radius_y], dim=-1),
                        torch.zeros((), dtype=radius_x.dtype, device=radius_x.device)
                        ).to(torch.int32)
    compensations = (torch.where(valid, compensation, torch.zeros_like(compensation))
                     if calc_compensations else None)
    return radii, mean2d, depths, conics, compensations
