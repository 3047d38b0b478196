"""Rendering orchestrators: project → SH → tile-sort → rasterize (port of
``tdgs/rendering.py:43 rasterization``, 3DGS, and ``:583
rasterization_2dgs``, surfels).

Two screen-space rasterizers are ported for each: ``"packed_inference"``
(forward only) and ``"packed"`` (differentiable: the training path). 3DGS
also has the world-space ``"eval3d_packed"`` (3DGUT, ``with_eval3d``),
differentiable, with the unscented-transform projection for its tiling
(``with_ut``), and the two tile-dense rasterizers over the dense tiling
(``isect_tiles``): ``"pallas"`` (kernels 9 and 10 behind autograd) and
``"jax"`` (the same function in plain tensor ops, differentiated by
autograd). The kernels run on the card and their plain PyTorch versions on
the CPU. The ``meta`` dicts carry the same keys as the JAX package's; the
packed rasterizers' ``isect_offsets`` is the packed stream's [T + 1]
offsets, the dense ones' the JAX package's [..., C, tile_height,
tile_width].
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tdgs_torch._device import DeviceLike, as_float, as_optional_float, resolve_device
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.ops.projection import fully_fused_projection
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut
from tdgs_torch.ops.rasterize_2dgs_packed import (
    rasterize_to_pixels_2dgs_packed,
    rasterize_to_pixels_2dgs_packed_inference,
)
from tdgs_torch.ops.rasterize_eval3d_packed import rasterize_to_pixels_eval3d_packed
from tdgs_torch.ops.rasterize_packed import (
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference,
)
from tdgs_torch.ops.rasterize_jax import rasterize_to_pixels_jax
from tdgs_torch.ops.rasterize_pallas import rasterize_to_pixels_pallas
from tdgs_torch.ops.sh import spherical_harmonics
from tdgs_torch.ops.tiling import isect_offset_encode, isect_tiles, isect_tiles_packed
from tdgs_torch.utils.depth import depth_to_normal, rotate

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")

# rasterizers of the JAX package that wait for a later slice of the port
_NOT_PORTED = {
    "eval3d": "ROADMAP queue 1, eval3d/3DGUT remainders: the dense jnp path",
}
_RASTERIZERS = ("packed_inference", "packed", "eval3d_packed", "jax", "pallas")


def default_isect_capacity(I: int, N: int) -> int:
    """The dense tiling's default capacity (``tdgs/rendering.py:35``): ~8
    covered tiles per (image, gaussian), rounded up to a power of two."""
    cap = max(I * N * 8, 1 << 14)
    return 1 << (cap - 1).bit_length()


def _colors_per_camera(colors, sh_degree, means, viewmats, radii):
    """Colours [..., C, N, D]: given per gaussian or per camera, or
    evaluated from SH coefficients toward each camera (``sh_degree``)."""
    batch_dims = tuple(means.shape[:-2])
    num_batch_dims = len(batch_dims)
    N, C = means.shape[-2], viewmats.shape[-3]
    if sh_degree is None:
        if colors.dim() == num_batch_dims + 2:
            return colors[..., None, :, :].expand(batch_dims + (C, N, colors.shape[-1]))
        return colors
    campos = torch.linalg.inv(viewmats)[..., :3, 3]  # [..., C, 3]
    dirs = means[..., None, :, :] - campos[..., :, None, :]  # [..., C, N, 3]
    masks = (radii > 0).all(dim=-1)
    if colors.dim() == num_batch_dims + 3:
        shs = colors[..., None, :, :, :].expand(batch_dims + (C, N) + tuple(colors.shape[-2:]))
    else:
        shs = colors
    return torch.clamp(spherical_harmonics(sh_degree, dirs, shs, masks=masks) + 0.5, min=0.0)


def rasterization(
    means,  # [..., N, 3]
    quats,  # [..., N, 4] or None with covars
    scales,  # [..., N, 3] or None with covars
    opacities,  # [..., N]
    colors,  # [..., (C,) N, D] or [..., (C,) N, K, 3]
    viewmats,  # [..., C, 4, 4]
    Ks,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds=None,  # [..., C, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    camera_model: str = "pinhole",
    covars=None,  # [..., N, 3, 3]
    isect_capacity: Optional[int] = None,
    tile_capacity: int = 1024,
    max_tiles_per_gauss: int = 32,
    isect_exact: bool = False,
    isect_exact_depth: bool = False,
    isect_split_k: Optional[int] = None,
    isect_big_capacity: Optional[int] = None,
    rasterizer: str = "packed_inference",
    means2d_offset=None,  # [..., C, N, 2]
    means2d_abs_tap=None,  # [..., C, N, 2]
    with_ut: bool = False,
    radial_coeffs=None,  # [..., C, 6] or [..., C, 4] (fisheye)
    tangential_coeffs=None,  # [..., C, 2]
    thin_prism_coeffs=None,  # [..., C, 4]
    ftheta_coeffs=None,  # FThetaCameraDistortionParameters
    rolling_shutter: Optional[RollingShutterType] = None,
    viewmats_rs=None,  # [..., C, 4, 4] frame-end poses
    with_eval3d: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Rasterize N 3D Gaussians to C cameras (arbitrary leading batch dims).

    Inputs may be tensors or arrays; they are taken to ``device`` as
    float32 (default CUDA; ``device="cpu"`` runs the plain versions).
    Returns (render_colors [..., C, H, W, X], render_alphas [..., C, H, W, 1],
    meta).

    ``rasterizer="packed"`` is differentiable, and so are the tile-dense
    ``"pallas"`` (kernels 9 and 10) and ``"jax"`` (plain tensor ops), which
    tile with ``isect_tiles`` at ``isect_capacity`` entries (default
    ``default_isect_capacity``) and ignore the ``isect_exact*``/split
    options, as the JAX package does. ``means2d_offset`` is added to the
    projected means (pass zeros: its gradient is the screen-space gradient
    the DefaultStrategy reads); the gradient of ``means2d_abs_tap`` (zeros)
    is the per-gaussian sum of |per-tile screen-space gradients| (AbsGS;
    ``"packed"`` and ``"jax"``).

    3DGUT: ``with_ut`` projects through the unscented transform (the camera
    model's distortion coefficients, FTheta, ``rolling_shutter`` between
    ``viewmats`` and ``viewmats_rs``); ``with_eval3d`` selects the
    world-space ``"eval3d_packed"`` rasterizer, which evaluates each
    gaussian along the pixels' true rays (differentiable, gradients also to
    ``viewmats`` and ``viewmats_rs``); the projection then only feeds the
    tiling. eval3d takes unbatched gaussians, quats and scales, and no
    AbsGS tap."""
    if with_eval3d and not rasterizer.startswith("eval3d"):
        rasterizer = "eval3d_packed"
    if rasterizer not in _RASTERIZERS:
        item = _NOT_PORTED.get(rasterizer)
        if item is None:
            raise ValueError(f"unknown rasterizer {rasterizer!r}")
        raise NotImplementedError(
            f"rasterizer={rasterizer!r} is not ported yet ({item})"
        )
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"rasterize_mode {rasterize_mode!r}")
    dev = resolve_device(device)
    means = as_float(means, dev)
    opacities = as_float(opacities, dev)
    colors = as_float(colors, dev)
    viewmats = as_float(viewmats, dev)
    Ks = as_float(Ks, dev)
    backgrounds = as_optional_float(backgrounds, dev)
    radial_coeffs, tangential_coeffs, thin_prism_coeffs, viewmats_rs = (
        as_optional_float(x, dev)
        for x in (radial_coeffs, tangential_coeffs, thin_prism_coeffs, viewmats_rs))
    rolling_shutter = RollingShutterType(rolling_shutter or RollingShutterType.GLOBAL)

    meta: Dict = {}
    batch_dims = tuple(means.shape[:-2])
    B = math.prod(batch_dims) if batch_dims else 1
    N = means.shape[-2]
    C = viewmats.shape[-3]
    I = B * C

    if covars is None:
        quats = as_float(quats, dev)
        scales = as_float(scales, dev)
        if quats.shape != batch_dims + (N, 4) or scales.shape != batch_dims + (N, 3):
            raise ValueError(f"quats {quats.shape} / scales {scales.shape}")
    else:
        covars = as_float(covars, dev)
        if covars.shape != batch_dims + (N, 3, 3):
            raise ValueError(f"covars {covars.shape}")
        quats, scales = None, None
    if opacities.shape != batch_dims + (N,):
        raise ValueError(f"opacities {opacities.shape}")
    if viewmats.shape != batch_dims + (C, 4, 4) or Ks.shape != batch_dims + (C, 3, 3):
        raise ValueError(f"viewmats {viewmats.shape} / Ks {Ks.shape}")

    if rasterizer == "eval3d_packed":
        if batch_dims:
            raise ValueError("eval3d takes unbatched [N] gaussians")
        if covars is not None:
            raise ValueError("eval3d needs quats and scales, not covars")
    if with_ut and covars is not None:
        raise ValueError("with_ut needs quats and scales, not covars")

    calc_compensations = rasterize_mode == "antialiased"
    if with_ut:
        radii, means2d, depths, conics, compensations = fully_fused_projection_with_ut(
            means, quats, scales, opacities, viewmats, Ks, width, height,
            eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, calc_compensations=calc_compensations,
            camera_model=camera_model, radial_coeffs=radial_coeffs,
            tangential_coeffs=tangential_coeffs, thin_prism_coeffs=thin_prism_coeffs,
            ftheta_coeffs=ftheta_coeffs, rolling_shutter=rolling_shutter,
            viewmats_rs=viewmats_rs,
        )
    else:
        radii, means2d, depths, conics, compensations = fully_fused_projection(
            means, quats, scales, viewmats, Ks, width, height,
            eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, calc_compensations=calc_compensations,
            camera_model=camera_model, opacities=opacities, covars=covars,
        )  # [..., C, N, ...]

    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    if means2d_abs_tap is not None and rasterizer not in ("packed", "jax"):
        raise ValueError("means2d_abs_tap is supported by the 'packed' and 'jax' "
                         "rasterizers only")

    opacities_cn = opacities[..., None, :].expand(batch_dims + (C, N))
    if compensations is not None:
        opacities_cn = opacities_cn * compensations
    meta.update({
        "camera_ids": None,
        "gaussian_ids": None,
        "radii": radii,
        "means2d": means2d,
        "depths": depths,
        "conics": conics,
        "opacities": opacities_cn,
    })

    colors_cn = _colors_per_camera(colors, sh_degree, means, viewmats, radii)

    # depth channels per render mode
    if render_mode in ("RGB+D", "RGB+ED"):
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        if backgrounds is not None:
            backgrounds = torch.cat(
                [backgrounds, backgrounds.new_zeros(batch_dims + (C, 1))], dim=-1
            )
    elif render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        if backgrounds is not None:
            backgrounds = backgrounds.new_zeros(batch_dims + (C, 1))

    tile_width = math.ceil(width / float(tile_size))
    tile_height = math.ceil(height / float(tile_size))
    dense = rasterizer in ("jax", "pallas")
    if dense:
        # the dense tiling at a fixed capacity (tdgs/rendering.py:519-547)
        isect = isect_tiles(
            means2d.detach(), radii, depths.detach(), tile_size, tile_width, tile_height,
            capacity=(default_isect_capacity(I, N) if isect_capacity is None
                      else isect_capacity),
            max_tiles_per_gauss=max_tiles_per_gauss,
        )
        offsets = isect_offset_encode(isect.isect_keys, I, tile_width, tile_height)
        meta.update({
            "tiles_per_gauss": isect.tiles_per_gauss,
            "isect_depths": isect.isect_depths,
            "isect_offsets": offsets.reshape(batch_dims + (C, tile_height, tile_width)),
        })
    else:
        isect = isect_tiles_packed(
            means2d.detach(), radii, depths.detach(), tile_size, tile_width, tile_height,
            max_tiles_per_gauss=max_tiles_per_gauss, capacity=isect_capacity,
            exact=isect_exact, exact_depth=isect_exact_depth,
            split_k=isect_split_k, big_capacity=isect_big_capacity,
        )
        offsets = isect.offsets
        meta["isect_offsets"] = offsets
    meta.update({
        "tile_width": tile_width,
        "tile_height": tile_height,
        "isect_ids": isect.isect_keys,
        "flatten_ids": isect.flatten_ids,
        "n_isects": isect.n_isects,
        "n_dropped": isect.n_dropped,
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_batches": B,
        "n_cameras": C,
    })
    raster_args = (
        means2d.contiguous(), conics.contiguous(), colors_cn.contiguous(),
        opacities_cn.contiguous(), width, height, tile_size, offsets, isect.flatten_ids,
    )
    bg = None if backgrounds is None else backgrounds.contiguous()
    abs_dummy = None if means2d_abs_tap is None else means2d_abs_tap.reshape(I * N, 2)
    if rasterizer == "eval3d_packed":
        # the projection only tiled: the response is taken along the rays
        render_colors, render_alphas = rasterize_to_pixels_eval3d_packed(
            means, quats, scales, colors_cn.reshape(I, N, -1).contiguous(),
            opacities_cn.reshape(I, N).contiguous(), viewmats.reshape(I, 4, 4),
            Ks.reshape(I, 3, 3), width, height, tile_size, isect.offsets,
            isect.flatten_ids, camera_model=camera_model, radial_coeffs=radial_coeffs,
            tangential_coeffs=tangential_coeffs, thin_prism_coeffs=thin_prism_coeffs,
            ftheta_coeffs=ftheta_coeffs,
            backgrounds=None if bg is None else bg.reshape(I, -1),
            tile_capacity=tile_capacity, rolling_shutter=rolling_shutter,
            viewmats_rs=None if viewmats_rs is None else viewmats_rs.reshape(I, 4, 4),
        )
        render_colors = render_colors.reshape((C, height, width, -1))
        render_alphas = render_alphas.reshape((C, height, width, 1))
    elif rasterizer == "pallas":
        render_colors, render_alphas = rasterize_to_pixels_pallas(
            *raster_args, isect.n_isects, backgrounds=bg, tile_capacity=tile_capacity)
    elif rasterizer == "jax":
        render_colors, render_alphas = rasterize_to_pixels_jax(
            *raster_args, isect.n_isects, backgrounds=bg, tile_capacity=tile_capacity,
            absgrad_dummy=abs_dummy)
    elif rasterizer == "packed":
        render_colors, render_alphas = rasterize_to_pixels_packed(
            *raster_args, backgrounds=bg, tile_capacity=tile_capacity,
            absgrad_dummy=abs_dummy)
    else:
        render_colors, render_alphas = rasterize_to_pixels_packed_inference(
            *raster_args, backgrounds=bg, tile_capacity=tile_capacity,
        )
    if render_mode in ("ED", "RGB+ED"):
        render_colors = torch.cat(
            [
                render_colors[..., :-1],
                render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10),
            ],
            dim=-1,
        )
    return render_colors, render_alphas, meta


# the 2DGS rasterizers of the JAX package that wait for a later slice
_NOT_PORTED_2DGS = {
    "jax": "ROADMAP queue 1, 2DGS family: rasterize_2dgs_jax.py",
}


def rasterization_2dgs(
    means,  # [..., N, 3]
    quats,  # [..., N, 4]
    scales,  # [..., N, 3] (z unused)
    opacities,  # [..., N]
    colors,  # [..., (C,) N, D] or [..., (C,) N, K, 3]
    viewmats,  # [..., C, 4, 4]
    Ks,  # [..., C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    sh_degree: Optional[int] = None,
    tile_size: int = 16,
    backgrounds=None,  # [..., C, D]
    render_mode: str = "RGB",
    distloss: bool = False,
    depth_mode: str = "expected",
    isect_capacity: Optional[int] = None,
    tile_capacity: int = 512,
    max_tiles_per_gauss: int = 32,
    isect_exact: bool = False,
    isect_exact_depth: bool = False,
    isect_split_k: Optional[int] = None,
    isect_big_capacity: Optional[int] = None,
    rasterizer: str = "packed_inference",
    means2d_offset=None,  # [..., C, N, 2]
    means2d_abs_tap=None,  # [..., C, N, 2]
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, ...]:
    """Rasterize 2D (surfel) Gaussians (port of ``tdgs/rendering.py:583
    rasterization_2dgs``). Returns (render_colors, render_alphas,
    render_normals [world frame], render_normals_from_depth, render_distort,
    render_median, meta).

    ``rasterizer``: ``"packed"`` (differentiable: kernels 5 and 6 behind
    autograd, all outputs; median depth is not differentiable) or
    ``"packed_inference"`` (forward only, kernel 4; distortion and median
    are zeros). A depth channel is appended to the colours when
    ``distloss`` is set or the render mode asks for depth; "ED" modes divide
    it by alpha after the render, and "RGB+ED"/"RGB+D" also return the
    normals of that depth map (``depth_mode="median"``: of the median
    depth). ``means2d_offset`` and ``means2d_abs_tap`` are the screen-space
    taps of :func:`rasterization`."""
    if rasterizer not in ("packed_inference", "packed"):
        item = _NOT_PORTED_2DGS.get(rasterizer)
        if item is None:
            raise ValueError(f"unknown rasterizer {rasterizer!r}")
        raise NotImplementedError(f"rasterizer={rasterizer!r} is not ported yet ({item})")
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    if means2d_abs_tap is not None and rasterizer != "packed":
        raise ValueError("means2d_abs_tap requires the differentiable 'packed' rasterizer")
    dev = resolve_device(device)
    means, quats, scales, opacities, colors, viewmats, Ks = (
        as_float(x, dev) for x in (means, quats, scales, opacities, colors, viewmats, Ks))
    backgrounds = as_optional_float(backgrounds, dev)

    batch_dims = tuple(means.shape[:-2])
    B = math.prod(batch_dims) if batch_dims else 1
    N = means.shape[-2]
    C = viewmats.shape[-3]
    I = B * C
    if quats.shape != batch_dims + (N, 4) or scales.shape != batch_dims + (N, 3):
        raise ValueError(f"quats {quats.shape} / scales {scales.shape}")
    if opacities.shape != batch_dims + (N,):
        raise ValueError(f"opacities {opacities.shape}")
    if viewmats.shape != batch_dims + (C, 4, 4) or Ks.shape != batch_dims + (C, 3, 3):
        raise ValueError(f"viewmats {viewmats.shape} / Ks {Ks.shape}")

    radii, means2d, depths, ray_transforms, normals = fully_fused_projection_2dgs(
        means, quats, scales, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
    )
    if means2d_offset is not None:
        if tuple(means2d_offset.shape) != tuple(means2d.shape):
            raise ValueError(f"means2d_offset {tuple(means2d_offset.shape)} for "
                             f"means2d {tuple(means2d.shape)}")
        means2d = means2d + means2d_offset
    opacities_cn = opacities[..., None, :].expand(batch_dims + (C, N))
    colors_cn = _colors_per_camera(colors, sh_degree, means, viewmats, radii)

    # the depth channel, when asked for (it also feeds distortion and median)
    need_depth = distloss or render_mode in ("D", "ED", "RGB+D", "RGB+ED")
    if render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        if backgrounds is not None:
            backgrounds = backgrounds.new_zeros(batch_dims + (C, 1))
    elif need_depth:
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        if backgrounds is not None:
            backgrounds = torch.cat(
                [backgrounds, backgrounds.new_zeros(batch_dims + (C, 1))], dim=-1)

    tile_width = math.ceil(width / float(tile_size))
    tile_height = math.ceil(height / float(tile_size))
    isect = isect_tiles_packed(
        means2d.detach(), radii, depths.detach(), tile_size, tile_width, tile_height,
        max_tiles_per_gauss=max_tiles_per_gauss, capacity=isect_capacity,
        exact=isect_exact, exact_depth=isect_exact_depth,
        split_k=isect_split_k, big_capacity=isect_big_capacity,
    )
    raster_args = (
        means2d.contiguous(), ray_transforms.contiguous(), colors_cn.contiguous(),
        normals.contiguous(), opacities_cn.contiguous(), width, height, tile_size,
        isect.offsets, isect.flatten_ids,
    )
    bg = None if backgrounds is None else backgrounds.contiguous()
    if rasterizer == "packed":
        (render_colors, render_alphas, render_normals_cam, render_distort,
         render_median) = rasterize_to_pixels_2dgs_packed(
            *raster_args, backgrounds=bg, tile_capacity=tile_capacity,
            has_depth=need_depth, compute_distort=distloss or need_depth,
            absgrad_dummy=(None if means2d_abs_tap is None
                           else means2d_abs_tap.reshape(I * N, 2)),
        )
    else:
        render_colors, render_alphas, render_normals_cam = (
            rasterize_to_pixels_2dgs_packed_inference(
                *raster_args, backgrounds=bg, tile_capacity=tile_capacity))
        render_distort = torch.zeros_like(render_alphas)
        render_median = torch.zeros_like(render_alphas)

    if render_mode in ("ED", "RGB+ED"):
        render_colors = torch.cat(
            [render_colors[..., :-1],
             render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)],
            dim=-1,
        )
    camtoworlds = torch.linalg.inv(viewmats)
    render_normals_from_depth = None
    if render_mode in ("RGB+ED", "RGB+D"):
        depth_for_normal = (render_colors[..., -1:] if depth_mode == "expected"
                            else render_median)
        render_normals_from_depth = depth_to_normal(depth_for_normal, camtoworlds, Ks)

    meta = {
        "radii": radii,
        "means2d": means2d,
        "depths": depths,
        "ray_transforms": ray_transforms,
        "opacities": opacities_cn,
        "normals": normals,
        "tile_width": tile_width,
        "tile_height": tile_height,
        "tiles_per_gauss": None,
        "isect_ids": isect.isect_keys,
        "flatten_ids": isect.flatten_ids,
        "isect_offsets": isect.offsets,
        "n_isects": isect.n_isects,
        "n_dropped": isect.n_dropped,
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_cameras": C,
        "render_distort": render_distort,
    }
    # normals to the world frame, in true float32
    render_normals = rotate(camtoworlds[..., :3, :3], render_normals_cam)
    return (render_colors, render_alphas, render_normals, render_normals_from_depth,
            render_distort, render_median, meta)
