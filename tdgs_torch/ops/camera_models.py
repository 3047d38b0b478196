"""Camera models with distortion and rolling shutter (port of
``tdgs/ops/camera_models.py``), plain tensor ops that autograd
differentiates:

- OpenCV pinhole distortion: rational radial k1..k6, tangential p1 p2,
  thin prism s1..s4, and its fixed-point inverse;
- the OpenCV fisheye (equidistant) model, k1..k4, and its Newton inverse;
- FTheta (polynomials angle ↔ pixel distance);
- rolling-shutter timing per pixel and the pose interpolated between the
  frame's start and end poses.

``project_point`` is the camera → pixel map of the UT projection
(``ops/projection_ut.py``); ``unproject_pixel`` the pixel → ray map of the
eval3d rasterizer (``ops/rasterize_eval3d_packed.py``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch.ops.transforms import quat_normalize, quat_to_rotmat, rotmat_to_quat


class RollingShutterType(enum.IntEnum):
    GLOBAL = 0
    TOP_TO_BOTTOM = 1
    LEFT_TO_RIGHT = 2
    BOTTOM_TO_TOP = 3
    RIGHT_TO_LEFT = 4


class FThetaPolynomialType(enum.IntEnum):
    PIXELDIST_TO_ANGLE = 0
    ANGLE_TO_PIXELDIST = 1


class FThetaCameraDistortionParameters(NamedTuple):
    """Degree-5 polynomial coefficients both ways and the largest angle."""

    reference_poly: int = int(FThetaPolynomialType.PIXELDIST_TO_ANGLE)
    pixeldist_to_angle_poly: Tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    angle_to_pixeldist_poly: Tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    max_angle: float = 3.14159 / 2


def _polyval(coeffs, x):
    out = torch.zeros_like(x)
    for c in reversed(list(coeffs)):
        out = out * x + c
    return out


def _radial_scale(r2, radial):
    if radial is None:
        return torch.ones_like(r2)
    k1, k2, k3, k4, k5, k6 = radial.unbind(-1)
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def _tangential_prism(x, y, r2, tangential, thin_prism):
    """The additive terms (dx, dy) of the tangential and thin-prism parts."""
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y)
    if tangential is not None:
        p1, p2 = tangential[..., 0], tangential[..., 1]
        dx = dx + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = dy + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    if thin_prism is not None:
        s1, s2, s3, s4 = thin_prism.unbind(-1)
        dx = dx + r2 * (s1 + s2 * r2)
        dy = dy + r2 * (s3 + s4 * r2)
    return dx, dy


def distort_opencv_pinhole(x, y, radial=None, tangential=None, thin_prism=None):
    """Full OpenCV pinhole distortion of normalized coordinates (x/z, y/z)."""
    r2 = x * x + y * y
    scale = _radial_scale(r2, radial)
    dx, dy = _tangential_prism(x, y, r2, tangential, thin_prism)
    return x * scale + dx, y * scale + dy


def distort_opencv_fisheye(x, y, coeffs=None):
    """OpenCV fisheye (equidistant) distortion."""
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-9
    r_safe = torch.where(small, torch.ones_like(r), r)
    theta = torch.atan(r)
    if coeffs is not None:
        k1, k2, k3, k4 = coeffs.unbind(-1)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    else:
        theta_d = theta
    scale = torch.where(small, torch.ones_like(r), theta_d / r_safe)
    return x * scale, y * scale


def project_point(
    p_cam: torch.Tensor,  # [..., 3] camera-space points
    Ks: torch.Tensor,  # [..., 3, 3]
    camera_model: str = "pinhole",
    radial_coeffs: Optional[torch.Tensor] = None,
    tangential_coeffs: Optional[torch.Tensor] = None,
    thin_prism_coeffs: Optional[torch.Tensor] = None,
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full nonlinear camera-space → pixel projection. Returns
    (pixels [..., 2], valid [...])."""
    fx, fy = Ks[..., 0, 0], Ks[..., 1, 1]
    cx, cy = Ks[..., 0, 2], Ks[..., 1, 2]
    X, Y, Z = p_cam.unbind(-1)

    if camera_model == "ftheta":
        params = ftheta_coeffs or FThetaCameraDistortionParameters()
        r3d = torch.sqrt(X * X + Y * Y)
        theta = torch.atan2(r3d, Z)
        rd = _polyval(params.angle_to_pixeldist_poly, theta)
        r_safe = torch.where(r3d < 1e-9, torch.ones_like(r3d), r3d)
        u = X / r_safe * rd
        v = Y / r_safe * rd
        return torch.stack([u + cx, v + cy], dim=-1), theta <= params.max_angle

    Z_safe = torch.where(Z.abs() < 1e-9, torch.full_like(Z, 1e-9), Z)
    x, y = X / Z_safe, Y / Z_safe
    if camera_model == "pinhole":
        xd, yd = distort_opencv_pinhole(x, y, radial_coeffs, tangential_coeffs,
                                        thin_prism_coeffs)
    elif camera_model == "fisheye":
        xd, yd = distort_opencv_fisheye(x, y, radial_coeffs)
    elif camera_model == "ortho":
        xd, yd = X, Y
    else:
        raise ValueError(camera_model)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1), Z > 0


def _undistort_opencv_pinhole(xd, yd, radial, tangential, thin_prism, iters: int = 8):
    """Invert ``distort_opencv_pinhole`` by fixed-point iteration (the
    cv2.undistortPoints scheme)."""
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        scale = _radial_scale(r2, radial)
        dx, dy = _tangential_prism(x, y, r2, tangential, thin_prism)
        scale = torch.where(scale.abs() < 1e-9, torch.full_like(scale, 1e-9), scale)
        x = (xd - dx) / scale
        y = (yd - dy) / scale
    return x, y


def _invert_fisheye_theta(theta_d, coeffs, iters: int = 8):
    """Solve θ·(1 + k1θ² + k2θ⁴ + k3θ⁶ + k4θ⁸) = θ_d by Newton."""
    if coeffs is None:
        return theta_d
    k1, k2, k3, k4 = coeffs.unbind(-1)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        df = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + 9.0 * k4 * t2)))
        theta = theta - (f - theta_d) / torch.where(df.abs() < 1e-9, torch.ones_like(df), df)
    return theta


def unproject_pixel(
    pixels: torch.Tensor,  # [..., 2] pixel centres
    Ks: torch.Tensor,  # [..., 3, 3]
    camera_model: str = "pinhole",
    radial_coeffs: Optional[torch.Tensor] = None,
    tangential_coeffs: Optional[torch.Tensor] = None,
    thin_prism_coeffs: Optional[torch.Tensor] = None,
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
) -> torch.Tensor:
    """Pixel → unit camera-space ray direction [..., 3] (the inverse of
    ``project_point``)."""
    fx, fy = Ks[..., 0, 0], Ks[..., 1, 1]
    cx, cy = Ks[..., 0, 2], Ks[..., 1, 2]
    u, v = pixels[..., 0], pixels[..., 1]

    if camera_model == "ftheta":
        params = ftheta_coeffs or FThetaCameraDistortionParameters()
        du, dv = u - cx, v - cy
        rd = torch.sqrt(du * du + dv * dv)
        on_axis = rd < 1e-9
        theta = _polyval(params.pixeldist_to_angle_poly, rd)
        rd_safe = torch.where(on_axis, torch.ones_like(rd), rd)
        s = torch.sin(theta)
        d = torch.stack([du / rd_safe * s, dv / rd_safe * s, torch.cos(theta)], dim=-1)
        # an on-axis pixel looks down +z (sin/rd is 0/0 there)
        z_axis = torch.zeros_like(d)
        z_axis[..., 2] = 1.0
        return torch.where(on_axis[..., None], z_axis, d)

    xd = (u - cx) / fx
    yd = (v - cy) / fy
    if camera_model == "pinhole":
        x, y = _undistort_opencv_pinhole(xd, yd, radial_coeffs, tangential_coeffs,
                                         thin_prism_coeffs)
    elif camera_model == "fisheye":
        theta_d = torch.sqrt(xd * xd + yd * yd)
        r = torch.tan(_invert_fisheye_theta(theta_d, radial_coeffs))
        td_safe = torch.where(theta_d < 1e-9, torch.ones_like(theta_d), theta_d)
        x = xd / td_safe * r
        y = yd / td_safe * r
    else:
        raise ValueError(f"unproject_pixel: unsupported camera model {camera_model!r}")
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d * torch.rsqrt((d * d).sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# rolling shutter
# ---------------------------------------------------------------------------


def interpolate_pose(
    viewmats_start: torch.Tensor,  # [..., 4, 4]
    viewmats_end: torch.Tensor,  # [..., 4, 4]
    t: torch.Tensor,  # [...] in [0, 1]
) -> torch.Tensor:
    """SE(3) interpolation between the frame's start and end poses:
    shortest-path quaternion nlerp and linear translation."""
    q0 = rotmat_to_quat(viewmats_start[..., :3, :3])
    q1 = rotmat_to_quat(viewmats_end[..., :3, :3])
    sign = torch.where((q0 * q1).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    tt = t[..., None]
    q = quat_normalize(q0 * (1.0 - tt) + q1 * sign * tt)
    trans = viewmats_start[..., :3, 3] * (1.0 - tt) + viewmats_end[..., :3, 3] * tt
    R = quat_to_rotmat(q)
    batch = torch.broadcast_shapes(R.shape[:-2], trans.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), trans.expand(batch + (3,))[..., None]], -1)
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def shutter_time_from_pixel(
    pixels: torch.Tensor,  # [..., 2]
    width: int,
    height: int,
    rs_type: RollingShutterType,
) -> torch.Tensor:
    """The normalized shutter time of a pixel for each rolling-shutter mode."""
    u = torch.clamp(pixels[..., 0] / width, 0.0, 1.0)
    v = torch.clamp(pixels[..., 1] / height, 0.0, 1.0)
    if rs_type == RollingShutterType.GLOBAL:
        return torch.zeros_like(u)
    if rs_type == RollingShutterType.TOP_TO_BOTTOM:
        return v
    if rs_type == RollingShutterType.LEFT_TO_RIGHT:
        return u
    if rs_type == RollingShutterType.BOTTOM_TO_TOP:
        return 1.0 - v
    if rs_type == RollingShutterType.RIGHT_TO_LEFT:
        return 1.0 - u
    raise ValueError(rs_type)
