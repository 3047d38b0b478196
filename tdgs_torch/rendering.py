"""Rendering orchestrators: project → SH → tile-sort → rasterize (port of
``tdgs/rendering.py:43 rasterization``, 3DGS, and ``:583
rasterization_2dgs``, surfels).

Two screen-space rasterizers are ported for each: ``"packed_inference"``
(forward only) and ``"packed"`` (differentiable: the training path). 3DGS
also has the world-space ``"eval3d_packed"`` (3DGUT, ``with_eval3d``),
differentiable, with the unscented-transform projection for its tiling
(``with_ut``), and three rasterizers over the dense tiling
(``isect_tiles``): ``"pallas"`` (kernels 9 and 10 behind autograd),
``"jax"`` (the same function in plain tensor ops, differentiated by
autograd) and the world-space ``"eval3d"`` (plain tensor ops). 2DGS also
has the dense ``"jax"`` (plain tensor ops). The kernels run on the card and
their plain PyTorch versions on the CPU. The ``meta`` dicts carry the same
keys as the JAX package's; the packed rasterizers' ``isect_offsets`` is the
packed stream's [T + 1] offsets, the dense ones' the JAX package's [..., C,
tile_height, tile_width].
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tdgs_torch._device import DeviceLike, as_float, as_optional_float, resolve_device
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.ops.projection import fully_fused_projection
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut, project_ut_for_tiles
from tdgs_torch.ops.rasterize_2dgs_jax import rasterize_to_pixels_2dgs_jax
from tdgs_torch.ops.rasterize_2dgs_packed import (
    rasterize_to_pixels_2dgs_packed,
    rasterize_to_pixels_2dgs_packed_inference,
)
from tdgs_torch.ops.rasterize_eval3d import rasterize_to_pixels_eval3d_jax
from tdgs_torch.ops.rasterize_eval3d_packed import rasterize_to_pixels_eval3d_packed
from tdgs_torch.ops.rasterize_packed import (
    max_entries_per_tile,
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference,
)
from tdgs_torch.ops.rasterize_jax import rasterize_to_pixels_jax
from tdgs_torch.ops.rasterize_pallas import rasterize_to_pixels_pallas
from tdgs_torch.ops.sh import spherical_harmonics
from tdgs_torch.ops.tiling import isect_offset_encode, isect_tiles, isect_tiles_packed
from tdgs_torch.utils.depth import depth_to_normal, rotate
from tdgs_torch.utils.profiler import host_read, span

RENDER_MODES = ("RGB", "D", "ED", "RGB+D", "RGB+ED")

_RASTERIZERS = ("packed_inference", "packed", "eval3d_packed", "eval3d", "jax", "pallas")
_RASTERIZERS_2DGS = ("packed_inference", "packed", "jax")


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
    # the inverse's error check reads its status on the host: a sync
    campos = host_read(viewmats, "sh", torch.linalg.inv)[..., :3, 3]  # [..., C, 3]
    dirs = means[..., None, :, :] - campos[..., :, None, :]  # [..., C, N, 3]
    masks = (radii > 0).all(dim=-1)
    if colors.dim() == num_batch_dims + 3:
        shs = colors[..., None, :, :, :].expand(batch_dims + (C, N) + tuple(colors.shape[-2:]))
    else:
        shs = colors
    return torch.clamp(spherical_harmonics(sh_degree, dirs, shs, masks=masks) + 0.5, min=0.0)


def with_depth_channel(colors_cn, depths, backgrounds, render_mode: str):
    """The colours and backgrounds a render mode rasterizes: "RGB+D" and
    "RGB+ED" append the depth channel (background 0 on it), "D" and "ED"
    render the depth alone (background 0)."""
    if render_mode in ("RGB+D", "RGB+ED"):
        colors_cn = torch.cat([colors_cn, depths[..., None]], dim=-1)
        if backgrounds is not None:
            backgrounds = torch.cat(
                [backgrounds, backgrounds.new_zeros(backgrounds.shape[:-1] + (1,))], dim=-1)
    elif render_mode in ("D", "ED"):
        colors_cn = depths[..., None]
        if backgrounds is not None:
            backgrounds = backgrounds.new_zeros(backgrounds.shape[:-1] + (1,))
    return colors_cn, backgrounds


def tile_stream(means2d, radii, depths, tile_size: int, width: int, height: int,
                dense: bool, isect_capacity: Optional[int], max_tiles_per_gauss: int,
                isect_exact: bool = False, isect_exact_depth: bool = False,
                isect_split_k: Optional[int] = None,
                isect_big_capacity: Optional[int] = None,
                tile_keep: Optional[int] = None):
    """The sorted intersection stream of projected gaussians [..., I, N]:
    the dense tiling at ``isect_capacity`` entries (``dense``) or the packed
    one, whose ``n_dropped`` also counts the entries past ``tile_keep`` in
    a tile where that is given. Returns (isect, the offsets the rasterizer
    takes, meta fields)."""
    image_dims = tuple(means2d.shape[:-2])
    I = math.prod(image_dims) if image_dims else 1
    tile_width = math.ceil(width / float(tile_size))
    tile_height = math.ceil(height / float(tile_size))
    if dense:
        isect = isect_tiles(
            means2d.detach(), radii, depths.detach(), tile_size, tile_width, tile_height,
            capacity=isect_capacity, max_tiles_per_gauss=max_tiles_per_gauss,
        )
        offsets = isect_offset_encode(isect.isect_keys, I, tile_width, tile_height)
        fields = {
            "tiles_per_gauss": isect.tiles_per_gauss,
            "isect_depths": isect.isect_depths,
            "isect_offsets": offsets.reshape(image_dims + (tile_height, tile_width)),
        }
    else:
        isect = isect_tiles_packed(
            means2d.detach(), radii, depths.detach(), tile_size, tile_width, tile_height,
            max_tiles_per_gauss=max_tiles_per_gauss, capacity=isect_capacity,
            exact=isect_exact, exact_depth=isect_exact_depth,
            split_k=isect_split_k, big_capacity=isect_big_capacity, tile_keep=tile_keep,
        )
        offsets = isect.offsets
        fields = {"isect_offsets": offsets}
    fields.update({
        "tile_width": tile_width,
        "tile_height": tile_height,
        "isect_ids": isect.isect_keys,
        "flatten_ids": isect.flatten_ids,
        "n_isects": isect.n_isects,
        "n_dropped": isect.n_dropped,
    })
    return isect, offsets, fields


def rasterize_screen(rasterizer: str, means2d, conics, colors_cn, opacities_cn, width: int,
                     height: int, tile_size: int, offsets, isect, backgrounds,
                     tile_capacity: int, abs_dummy=None):
    """Composite the stream with a screen-space rasterizer ("packed",
    "packed_inference", "pallas" or "jax") → (colors, alphas)."""
    raster_args = (
        means2d.contiguous(), conics.contiguous(), colors_cn.contiguous(),
        opacities_cn.contiguous(), width, height, tile_size, offsets, isect.flatten_ids,
    )
    if rasterizer == "pallas":
        return rasterize_to_pixels_pallas(
            *raster_args, isect.n_isects, backgrounds=backgrounds,
            tile_capacity=tile_capacity)
    if rasterizer == "jax":
        return rasterize_to_pixels_jax(
            *raster_args, isect.n_isects, backgrounds=backgrounds,
            tile_capacity=tile_capacity, absgrad_dummy=abs_dummy)
    if rasterizer == "packed":
        return rasterize_to_pixels_packed(
            *raster_args, backgrounds=backgrounds, tile_capacity=tile_capacity,
            absgrad_dummy=abs_dummy)
    return rasterize_to_pixels_packed_inference(
        *raster_args, backgrounds=backgrounds, tile_capacity=tile_capacity)


def rasterize_surfels(rasterizer: str, means2d, ray_transforms, colors_cn, normals,
                      opacities_cn, width: int, height: int, tile_size: int, offsets, isect,
                      backgrounds, tile_capacity: int, has_depth: bool,
                      compute_distort: bool, abs_dummy=None):
    """Composite a surfel stream with a 2DGS rasterizer ("packed",
    "packed_inference" or "jax") → (colors, alphas, camera-frame normals,
    distortion, median depth); the forward-only rasterizer gives zeros for
    the last two."""
    raster_args = (
        means2d.contiguous(), ray_transforms.contiguous(), colors_cn.contiguous(),
        normals.contiguous(), opacities_cn.contiguous(), width, height, tile_size,
        offsets, isect.flatten_ids,
    )
    bg = None if backgrounds is None else backgrounds.contiguous()
    if rasterizer == "jax":
        return rasterize_to_pixels_2dgs_jax(
            *raster_args, isect.n_isects, backgrounds=bg, tile_capacity=tile_capacity,
            compute_distort=compute_distort, absgrad_dummy=abs_dummy)
    if rasterizer == "packed":
        return rasterize_to_pixels_2dgs_packed(
            *raster_args, backgrounds=bg, tile_capacity=tile_capacity,
            has_depth=has_depth, compute_distort=compute_distort, absgrad_dummy=abs_dummy)
    render_colors, render_alphas, render_normals_cam = (
        rasterize_to_pixels_2dgs_packed_inference(
            *raster_args, backgrounds=bg, tile_capacity=tile_capacity))
    return (render_colors, render_alphas, render_normals_cam,
            torch.zeros_like(render_alphas), torch.zeros_like(render_alphas))


def expected_depth(render_colors, render_alphas, render_mode: str):
    """"ED" modes: the accumulated depth channel divided by alpha."""
    if render_mode not in ("ED", "RGB+ED"):
        return render_colors
    return torch.cat(
        [render_colors[..., :-1],
         render_colors[..., -1:] / torch.clamp(render_alphas, min=1e-10)],
        dim=-1,
    )


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
    # the reference's drop-in kwargs (gsplat/rendering.py:33 argument set)
    packed: Optional[bool] = None,
    sparse_grad: bool = False,
    segmented: bool = False,
    absgrad: bool = False,
    channel_chunk: int = 32,
    distributed: bool = False,
    with_eval3d: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Rasterize N 3D Gaussians to C cameras (arbitrary leading batch dims).

    Inputs may be tensors or arrays; they are taken to ``device`` as
    float32 (default CUDA; ``device="cpu"`` runs the plain versions).
    Returns (render_colors [..., C, H, W, X], render_alphas [..., C, H, W, 1],
    meta).

    ``rasterizer="packed"`` is differentiable, and so are the tile-dense
    ``"pallas"`` (kernels 9 and 10), ``"jax"`` (plain tensor ops) and the
    world-space ``"eval3d"`` (plain tensor ops), which tile with
    ``isect_tiles`` at ``isect_capacity`` entries (default
    ``default_isect_capacity``) and ignore the ``isect_exact*``/split
    options, as the JAX package does. ``means2d_offset`` is added to the
    projected means (pass zeros: its gradient is the screen-space gradient
    the DefaultStrategy reads); the gradient of ``means2d_abs_tap`` (zeros)
    is the per-gaussian sum of |per-tile screen-space gradients| (AbsGS;
    ``"packed"`` and ``"jax"``).

    3DGUT: ``with_ut`` projects through the unscented transform (the camera
    model's distortion coefficients, FTheta, ``rolling_shutter`` between
    ``viewmats`` and ``viewmats_rs``); ``with_eval3d`` selects the
    world-space ``"eval3d_packed"`` rasterizer (or its dense ``"eval3d"``
    when that is asked for), which evaluates each gaussian along the
    pixels' true rays (differentiable, gradients also to ``viewmats`` and
    ``viewmats_rs``); the projection then only feeds the tiling. eval3d
    takes unbatched gaussians, quats and scales, and no AbsGS tap.

    The reference's drop-in kwargs, as the JAX package takes them:
    ``packed``, ``sparse_grad``, ``segmented`` and ``channel_chunk`` name
    layouts and chunkings of the reference's CUDA build and are accepted
    and ignored; ``absgrad=True`` needs ``means2d_abs_tap`` (its gradient
    is the AbsGS signal) and raises without it; ``distributed=True`` is a
    no-op in a single process and, in a joined ``torch.distributed`` world
    of more ranks, renders this rank's cameras from every rank's gaussians
    through ``parallel.rasterization_sharded`` (the gaussians and cameras
    given are this rank's; unbatched, not eval3d or UT)."""
    if absgrad and means2d_abs_tap is None:
        raise ValueError(
            "absgrad: pass means2d_abs_tap=torch.zeros(batch + (C, N, 2)) and take the "
            "gradient of the loss w.r.t. that input (the AbsGS signal, as the trainer's "
            "DefaultStrategy absgrad path does)")
    del packed, sparse_grad, segmented, channel_chunk
    if distributed and torch.distributed.is_initialized() and (
            torch.distributed.get_world_size() > 1):
        return _rasterization_distributed(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height, device,
            rasterizer=rasterizer, with_eval3d=with_eval3d, with_ut=with_ut,
            sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane, eps2d=eps2d,
            radius_clip=radius_clip, tile_size=tile_size, backgrounds=backgrounds,
            render_mode=render_mode, rasterize_mode=rasterize_mode,
            isect_capacity=isect_capacity, tile_capacity=tile_capacity,
            max_tiles_per_gauss=max_tiles_per_gauss)
    if with_eval3d and not rasterizer.startswith("eval3d"):
        rasterizer = "eval3d_packed"
    if rasterizer not in _RASTERIZERS:
        raise ValueError(f"unknown rasterizer {rasterizer!r}")
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

    if rasterizer.startswith("eval3d"):
        if batch_dims:
            raise ValueError("eval3d takes unbatched [N] gaussians")
        if covars is not None:
            raise ValueError("eval3d needs quats and scales, not covars")
    if with_ut and covars is not None:
        raise ValueError("with_ut needs quats and scales, not covars")

    calc_compensations = rasterize_mode == "antialiased"
    with span("project"):
        if with_ut:
            # under eval3d the projection only tiles, unless its compensations
            # scale the opacities or its depths are a colour channel: no
            # gradient flows back through it, and the forward kernel serves
            only_tiles = (rasterizer.startswith("eval3d") and not calc_compensations
                          and render_mode == "RGB")
            project = project_ut_for_tiles if only_tiles else fully_fused_projection_with_ut
            radii, means2d, depths, conics, compensations = project(
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

    with span("sh"):
        colors_cn = _colors_per_camera(colors, sh_degree, means, viewmats, radii)
        colors_cn, backgrounds = with_depth_channel(colors_cn, depths, backgrounds, render_mode)

    dense = rasterizer in ("jax", "pallas", "eval3d")
    with span("tile_sort"):
        # the eval3d path counts its tiles' cut in n_dropped too; the
        # screen-space paths keep the JAX package's count
        isect, offsets, tile_meta = tile_stream(
            means2d, radii, depths, tile_size, width, height, dense,
            default_isect_capacity(I, N) if dense and isect_capacity is None else isect_capacity,
            max_tiles_per_gauss, isect_exact=isect_exact, isect_exact_depth=isect_exact_depth,
            isect_split_k=isect_split_k, isect_big_capacity=isect_big_capacity,
            tile_keep=(max_entries_per_tile(tile_capacity) if rasterizer == "eval3d_packed"
                       else None))
    meta.update(tile_meta)
    meta.update({
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_batches": B,
        "n_cameras": C,
    })
    bg = None if backgrounds is None else backgrounds.contiguous()
    abs_dummy = None if means2d_abs_tap is None else means2d_abs_tap.reshape(I * N, 2)
    eval3d_cams = dict(
        camera_model=camera_model, radial_coeffs=radial_coeffs,
        tangential_coeffs=tangential_coeffs, thin_prism_coeffs=thin_prism_coeffs,
        ftheta_coeffs=ftheta_coeffs, backgrounds=None if bg is None else bg.reshape(I, -1),
        tile_capacity=tile_capacity, rolling_shutter=rolling_shutter,
        viewmats_rs=None if viewmats_rs is None else viewmats_rs.reshape(I, 4, 4))
    with span("composite"):
        if rasterizer == "eval3d":
            # the dense world-space oracle over the dense tiling
            render_colors, render_alphas = rasterize_to_pixels_eval3d_jax(
                means, quats, scales, colors_cn.reshape(I, N, -1),
                opacities_cn.reshape(I, N), viewmats.reshape(I, 4, 4), Ks.reshape(I, 3, 3),
                width, height, tile_size, offsets, isect.flatten_ids, isect.n_isects,
                **eval3d_cams)
            render_colors = render_colors.reshape((C, height, width, -1))
            render_alphas = render_alphas.reshape((C, height, width, 1))
        elif rasterizer == "eval3d_packed":
            # the projection only tiled: the response is taken along the rays
            render_colors, render_alphas = rasterize_to_pixels_eval3d_packed(
                means, quats, scales, colors_cn.reshape(I, N, -1).contiguous(),
                opacities_cn.reshape(I, N).contiguous(), viewmats.reshape(I, 4, 4),
                Ks.reshape(I, 3, 3), width, height, tile_size, isect.offsets,
                isect.flatten_ids, **eval3d_cams)
            render_colors = render_colors.reshape((C, height, width, -1))
            render_alphas = render_alphas.reshape((C, height, width, 1))
        else:
            render_colors, render_alphas = rasterize_screen(
                rasterizer, means2d, conics, colors_cn, opacities_cn, width, height, tile_size,
                offsets, isect, bg, tile_capacity, abs_dummy)
        render_colors = expected_depth(render_colors, render_alphas, render_mode)
    return render_colors, render_alphas, meta


def _rasterization_distributed(means, quats, scales, opacities, colors, viewmats, Ks,
                               width, height, device, rasterizer, with_eval3d, with_ut,
                               **kw):
    """``rasterization(distributed=True)`` in a world of several ranks: this
    rank's cameras rendered from every rank's gaussians by
    ``parallel.rasterization_sharded`` over a mesh of the whole world."""
    from tdgs_torch.parallel import make_mesh, rasterization_sharded

    dev = resolve_device(device)
    means = as_float(means, dev)
    if means.dim() != 2:
        raise ValueError("distributed=True takes unbatched [N] gaussians")
    if with_eval3d or rasterizer.startswith("eval3d") or with_ut:
        raise ValueError("distributed eval3d/UT: call parallel.rasterization_eval3d_sharded")
    quats, scales, opacities, colors, viewmats, Ks = (
        as_float(x, dev) for x in (quats, scales, opacities, colors, viewmats, Ks))
    kw["backgrounds"] = as_optional_float(kw["backgrounds"], dev)
    return rasterization_sharded(means, quats, scales, opacities, colors, viewmats, Ks,
                                 width, height, make_mesh(device=dev), rasterizer=rasterizer,
                                 **kw)


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
    # the reference's drop-in kwargs (gsplat/rendering.py:1270 argument set)
    eps2d: float = 0.3,
    packed: Optional[bool] = None,
    sparse_grad: bool = False,
    absgrad: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, ...]:
    """Rasterize 2D (surfel) Gaussians (port of ``tdgs/rendering.py:583
    rasterization_2dgs``). Returns (render_colors, render_alphas,
    render_normals [world frame], render_normals_from_depth, render_distort,
    render_median, meta).

    ``rasterizer``: ``"packed"`` (differentiable: kernels 5 and 6 behind
    autograd, all outputs; median depth is not differentiable),
    ``"packed_inference"`` (forward only, kernel 4; distortion and median
    are zeros) or the dense ``"jax"`` (plain tensor ops over
    ``isect_tiles`` at ``isect_capacity`` entries, default
    ``default_isect_capacity``; differentiable by autograd, all outputs).
    A depth channel is appended to the colours when
    ``distloss`` is set or the render mode asks for depth; "ED" modes divide
    it by alpha after the render, and "RGB+ED"/"RGB+D" also return the
    normals of that depth map (``depth_mode="median"``: of the median
    depth). ``means2d_offset`` and ``means2d_abs_tap`` are the screen-space
    taps of :func:`rasterization`. On the ``"packed"`` path the entries
    past a tile's ``tile_capacity`` cut count in ``n_dropped`` too, as the
    eval3d path counts them. The reference's drop-in ``eps2d``,
    ``packed`` and ``sparse_grad`` are accepted and ignored (its own 2DGS
    projection never reads eps2d); ``absgrad=True`` needs
    ``means2d_abs_tap``, as in :func:`rasterization`."""
    if absgrad and means2d_abs_tap is None:
        raise ValueError(
            "absgrad: pass means2d_abs_tap=torch.zeros(batch + (C, N, 2)) and take the "
            "gradient of the loss w.r.t. that input (the AbsGS signal)")
    del eps2d, packed, sparse_grad
    if rasterizer not in _RASTERIZERS_2DGS:
        raise ValueError(f"unknown rasterizer {rasterizer!r}")
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    if means2d_abs_tap is not None and rasterizer == "packed_inference":
        raise ValueError("means2d_abs_tap requires a differentiable rasterizer")
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

    with span("project"):
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
    with span("sh"):
        colors_cn = _colors_per_camera(colors, sh_degree, means, viewmats, radii)
        # the depth channel, when asked for (it also feeds distortion and median)
        need_depth = distloss or render_mode in ("D", "ED", "RGB+D", "RGB+ED")
        colors_cn, backgrounds = with_depth_channel(
            colors_cn, depths, backgrounds,
            "RGB+D" if need_depth and render_mode not in ("D", "ED") else render_mode)

    dense = rasterizer == "jax"
    with span("tile_sort"):
        isect, offsets, tile_meta = tile_stream(
            means2d, radii, depths, tile_size, width, height, dense,
            default_isect_capacity(I, N) if dense and isect_capacity is None else isect_capacity,
            max_tiles_per_gauss, isect_exact=isect_exact, isect_exact_depth=isect_exact_depth,
            isect_split_k=isect_split_k, isect_big_capacity=isect_big_capacity,
            tile_keep=(max_entries_per_tile(tile_capacity) if rasterizer == "packed"
                       else None))
    abs_dummy = None if means2d_abs_tap is None else means2d_abs_tap.reshape(I * N, 2)
    with span("composite"):
        (render_colors, render_alphas, render_normals_cam, render_distort,
         render_median) = rasterize_surfels(
            rasterizer, means2d, ray_transforms, colors_cn, normals, opacities_cn, width,
            height, tile_size, offsets, isect, backgrounds, tile_capacity, need_depth,
            distloss or need_depth, abs_dummy)
        render_colors = expected_depth(render_colors, render_alphas, render_mode)
        camtoworlds = torch.linalg.inv(viewmats)
        render_normals_from_depth = None
        if render_mode in ("RGB+ED", "RGB+D"):
            depth_for_normal = (render_colors[..., -1:] if depth_mode == "expected"
                                else render_median)
            with span("depth_normal"):
                render_normals_from_depth = depth_to_normal(depth_for_normal, camtoworlds, Ks)
        # normals to the world frame, in true float32
        render_normals = rotate(camtoworlds[..., :3, :3], render_normals_cam)

    meta = {
        "radii": radii,
        "means2d": means2d,
        "depths": depths,
        "ray_transforms": ray_transforms,
        "opacities": opacities_cn,
        "normals": normals,
        "tile_width": tile_meta["tile_width"],
        "tile_height": tile_meta["tile_height"],
        "tiles_per_gauss": tile_meta.get("tiles_per_gauss"),
        "isect_ids": isect.isect_keys,
        "flatten_ids": isect.flatten_ids,
        "isect_offsets": tile_meta["isect_offsets"],
        "n_isects": isect.n_isects,
        "n_dropped": isect.n_dropped,
        "width": width,
        "height": height,
        "tile_size": tile_size,
        "n_cameras": C,
        "render_distort": render_distort,
    }
    return (render_colors, render_alphas, render_normals, render_normals_from_depth,
            render_distort, render_median, meta)


def rasterization_inria_wrapper(
    means, quats, scales, opacities, colors, viewmats, Ks,
    width: int, height: int,
    near_plane: float = 0.01, far_plane: float = 100.0,
    eps2d: float = 0.3, sh_degree=None, backgrounds=None, **kwargs,
):
    """The calling convention of the Inria rasterizer's wrapper (``tdgs/
    rendering.py:855``): ``eps2d`` fixed at 0.3 and a far plane of 100,
    rendered by :func:`rasterization`."""
    if eps2d != 0.3:
        raise ValueError(f"the Inria convention fixes eps2d at 0.3, got {eps2d}")
    return rasterization(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, eps2d=eps2d,
        sh_degree=sh_degree, backgrounds=backgrounds, **kwargs,
    )


def rasterization_2dgs_inria_wrapper(
    means, quats, scales, opacities, colors, viewmats, Ks,
    width: int, height: int,
    near_plane: float = 0.01, far_plane: float = 100.0,
    sh_degree=None, backgrounds=None, **kwargs,
):
    """The surfel rasterizer's twin of :func:`rasterization_inria_wrapper`
    (``tdgs/rendering.py:875``): a far plane of 100, rendered by
    :func:`rasterization_2dgs`."""
    return rasterization_2dgs(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane,
        sh_degree=sh_degree, backgrounds=backgrounds, **kwargs,
    )
