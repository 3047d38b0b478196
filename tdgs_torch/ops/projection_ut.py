"""Unscented-transform projection (port of ``tdgs/ops/projection_ut.py``,
3DGUT).

In place of the EWA Jacobian, the 2n + 1 = 7 sigma points of each 3D
gaussian go through the full nonlinear camera model (``camera_models``:
distortion, FTheta, rolling shutter with iterated shutter-time pose
interpolation) and the 2D moments are fitted again. The matrix square root
of Σ is R·S from the quaternion and scales. Two functions compute it:

- :func:`fully_fused_projection_with_ut`, plain tensor ops that autograd
  differentiates: for every call through which a gradient flows (a
  screen-space rasterizer with ``with_ut``; eval3d with ``antialiased``,
  whose compensations scale the opacities; eval3d with a depth render
  mode, whose depths become a colour channel);
- :func:`project_ut_for_tiles`, its outputs without gradients, for the
  calls that only tile (an eval3d ``classic`` render of colours alone in
  ``rendering.rasterization`` and ``parallel.sharded_render``, and
  ``tiling.derive_isect_plan``): on the card one launch of the
  hand-written kernel ``tdgs_torch/csrc/ut_project.cu``, on the CPU the
  plain chain under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.camera_models import (
    FThetaCameraDistortionParameters,
    RollingShutterType,
    interpolate_pose,
    project_point,
    shutter_time_from_pixel,
)
from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.transforms import quat_to_rotmat, rotmat_to_quat

KERNEL = "ut_project"


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


# ---------------------------------------------------------------------------
# the forward-only kernel
# ---------------------------------------------------------------------------

# camera model → csrc/ut_project.cu's CameraKind (1: the pinhole with any
# distortion coefficient given)
_CAMERA_KINDS = {"pinhole": 0, "fisheye": 2, "ftheta": 3, "ortho": 4}
_POLY_MAX = 8


class _KernelArgs(ctypes.Structure):
    """``UtProjectArgs`` of ``csrc/ut_project.cu``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "means", "quats", "scales", "opacities", "viewmats", "Ks", "radial",
            "tangential", "thin_prism", "viewmats_rs", "rs_quats", "radii", "means2d",
            "depths", "conics")]
        + [(name, ctypes.c_int64) for name in ("n_rows", "n_gauss", "n_cams")]
        + [(name, ctypes.c_int32) for name in (
            "camera", "rs_type", "rs_iterations", "require_all", "n_poly", "vec_quats")]
        + [(name, ctypes.c_float) for name in (
            "width", "height", "eps2d", "near_plane", "far_plane", "radius_clip", "lo_x",
            "hi_x", "lo_y", "hi_y", "gamma", "w_mean0", "w_cov0", "w_i", "alpha_threshold",
            "extend_max")]
        + [("poly", ctypes.c_float * _POLY_MAX), ("max_angle", ctypes.c_float)])


@functools.cache
def _load_kernel():
    fn = _build.load(KERNEL).tdgs_ut_project
    fn.argtypes = [ctypes.POINTER(_KernelArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def project_ut_for_tiles(
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
    """:func:`fully_fused_projection_with_ut`'s outputs, with no gradient:
    for a caller whose gradient flows through none of them (the projection
    only tiles). It computes no compensations: ``calc_compensations`` must
    be False (a caller that scales opacities by them takes the chain), and
    the fifth output is None.

    CUDA tensors launch the CUDA kernel once (or raise ``ValueError``):
    float32 throughout, all on one device; means, quats, scales and
    opacities contiguous, with the batch dimensions of the cameras; the
    per-camera tensors (poses, intrinsics, coefficients) are taken as they
    come. Under a rolling shutter the poses' quaternions are computed here,
    on the device, once a camera. CPU tensors take the plain chain under
    ``torch.no_grad()``."""
    if calc_compensations:
        raise ValueError("calc_compensations: the compensations carry a gradient; "
                         "take fully_fused_projection_with_ut")
    dev = means.device
    if dev.type == "cpu":
        with torch.no_grad():
            return fully_fused_projection_with_ut(
                means, quats, scales, opacities, viewmats, Ks, width, height, eps2d,
                near_plane, far_plane, radius_clip, False, camera_model,
                ut_params, radial_coeffs, tangential_coeffs, thin_prism_coeffs, ftheta_coeffs,
                rolling_shutter, viewmats_rs, rs_iterations)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if camera_model not in _CAMERA_KINDS:
        raise ValueError(f"unknown camera model {camera_model!r}")
    if means.dim() < 2 or viewmats.dim() < 3:
        raise ValueError(f"means {tuple(means.shape)} / viewmats {tuple(viewmats.shape)}")
    batch, N, C = tuple(means.shape[:-2]), means.shape[-2], viewmats.shape[-3]
    rs = rolling_shutter != RollingShutterType.GLOBAL and viewmats_rs is not None
    rows = {"means": (means, (N, 3)), "quats": (quats, (N, 4)), "scales": (scales, (N, 3))}
    if opacities is not None:
        rows["opacities"] = (opacities, (N,))
    cams = {"viewmats": (viewmats, (C, 4, 4)), "Ks": (Ks, (C, 3, 3))}
    if camera_model == "pinhole":
        for what, t, width_k in (("radial_coeffs", radial_coeffs, 6),
                                 ("tangential_coeffs", tangential_coeffs, 2),
                                 ("thin_prism_coeffs", thin_prism_coeffs, 4)):
            if t is not None:
                cams[what] = (t, (C, width_k))
    elif camera_model == "fisheye" and radial_coeffs is not None:
        cams["radial_coeffs"] = (radial_coeffs, (C, 4))
    if rs:
        cams["viewmats_rs"] = (viewmats_rs, (C, 4, 4))
    for group, contiguous in ((rows, True), (cams, False)):
        for what, (t, shape) in group.items():
            if t.dtype != torch.float32:
                raise ValueError(f"{what}: expected torch.float32, got {t.dtype}")
            if t.device != dev:
                raise ValueError(f"{what}: expected device {dev}, got {t.device}")
            if tuple(t.shape) != batch + shape:
                raise ValueError(f"{what}: expected shape {batch + shape}, got "
                                 f"{tuple(t.shape)}")
            if contiguous and not t.is_contiguous():
                raise ValueError(f"{what}: must be contiguous")
    kind = _CAMERA_KINDS[camera_model]
    if camera_model == "pinhole" and any(
            c in cams for c in ("radial_coeffs", "tangential_coeffs", "thin_prism_coeffs")):
        kind = 1
    ft = ftheta_coeffs or FThetaCameraDistortionParameters()
    poly = tuple(ft.angle_to_pixeldist_poly) if camera_model == "ftheta" else ()
    if len(poly) > _POLY_MAX:
        raise ValueError(f"ftheta_coeffs: at most {_POLY_MAX} coefficients, got {len(poly)}")

    with torch.no_grad():
        ins = {k: t.detach() if k in rows else t.detach().contiguous()
               for k, (t, _) in {**rows, **cams}.items()}
        rs_quats = None
        if rs:
            # interpolate_pose's quaternions of the frame's start and end,
            # the end's sign taken so that the nlerp takes the short way
            q0 = rotmat_to_quat(ins["viewmats"][..., :3, :3])
            q1 = rotmat_to_quat(ins["viewmats_rs"][..., :3, :3])
            sign = torch.where((q0 * q1).sum(-1, keepdim=True) < 0, -1.0, 1.0)
            rs_quats = torch.stack([q0, q1 * sign], dim=-2).contiguous()
        out_shape = batch + (C, N)
        radii = torch.empty(out_shape + (2,), dtype=torch.int32, device=dev)
        means2d = torch.empty(out_shape + (2,), dtype=torch.float32, device=dev)
        depths = torch.empty(out_shape, dtype=torch.float32, device=dev)
        conics = torch.empty(out_shape + (3,), dtype=torch.float32, device=dev)

    # the plain chain's constants, rounded to float32 as its tensors take them
    n_dim = 3
    alpha, beta, kappa = ut_params.alpha, ut_params.beta, ut_params.kappa
    lam = alpha * alpha * (n_dim + kappa) - n_dim
    w_mean_0 = lam / (n_dim + lam)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _KernelArgs(
        ptr(ins["means"]), ptr(ins["quats"]), ptr(ins["scales"]), ptr(ins.get("opacities")),
        ptr(ins["viewmats"]), ptr(ins["Ks"]), ptr(ins.get("radial_coeffs")),
        ptr(ins.get("tangential_coeffs")), ptr(ins.get("thin_prism_coeffs")),
        ptr(ins.get("viewmats_rs")), ptr(rs_quats), ptr(radii), ptr(means2d), ptr(depths),
        ptr(conics),
        radii.numel() // 2, N, C,
        kind, int(rolling_shutter), rs_iterations, bool(ut_params.require_all_sigma_points_valid),
        len(poly), ins["quats"].data_ptr() % 16 == 0,
        width, height, eps2d, near_plane, far_plane, radius_clip,
        -ut_params.in_image_margin_factor * width,
        width + ut_params.in_image_margin_factor * width,
        -ut_params.in_image_margin_factor * height,
        height + ut_params.in_image_margin_factor * height,
        (n_dim + lam) ** 0.5, w_mean_0, w_mean_0 + (1.0 - alpha * alpha + beta),
        1.0 / (2.0 * (n_dim + lam)), ALPHA_THRESHOLD, 3.33,
        (ctypes.c_float * _POLY_MAX)(*poly), ft.max_angle)
    fn = _load_kernel()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(launch), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL)
    return radii, means2d, depths, conics, None
