"""Gaussian-sharded rendering over ``torch.distributed`` (port of
``tdgs/parallel/sharded_render.py``).

The JAX package runs one ``shard_map`` over a mesh; the port runs the same
program on every rank (SPMD), one process each. The layout is the one
``NamedSharding(P("gauss"))`` gives JAX: rank r holds the contiguous block
r of the gaussian rows (``capacity / world``) and block r of the cameras
(``C / world``). Each function takes and returns this rank's blocks:

    gather the column's cameras          comm.all_gather (viewmats, Ks)
    project the local gaussians          [C, n, ...] against every camera
    exchange camera-major → gauss-major  comm.all_to_all: [C, n] → [C/D, N]
    tile and rasterize the local cameras the single-device stream and kernels

The exchange ships one packed float32 tensor per render (the JAX package
ships each array on its own): means2d, conics (or the 2DGS ray transform M
and normals, or the eval3d feature rows), opacities, depths, radii and
colours. Its backward is the same exchange transposed, which returns each
gaussian's gradient to its owner. After the exchange a rank's N rows are
the ranks' blocks in rank order, which is the global order, so the stream
(``flatten_ids``, the order of depth ties) is the one a single-rank render
of the same cameras builds: kernels 1–3 (``"packed"``, ``"packed_inference"``),
4–6 (2DGS), 7–8 (eval3d) and 9–10 (``"pallas"``) run on it unchanged.

``meta["radii"]`` and ``meta["means2d"]`` are the pre-exchange arrays
[C_col, n, 2] (this rank's gaussians against every camera of its column),
for visibility masks and the densification taps; ``meta["n_dropped"]`` is
this rank's count, shape [1]. ``batch_axis`` names the frame axis of a 2-D
mesh: the camera gather and the exchange stay inside the rank's gauss
group (its frame column), cameras split over (frame, gauss) and the
gaussians are held alike along the frame axis, their gradients summed
over it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tdgs_torch._device import as_float, as_optional_float
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.ops.projection import fully_fused_projection
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut, project_ut_for_tiles
from tdgs_torch.ops.rasterize_eval3d_packed import (
    feature_rows,
    rasterize_feature_rows,
    tile_rays_world,
)
from tdgs_torch.parallel import comm
from tdgs_torch.parallel.mesh import Mesh
from tdgs_torch.rendering import (
    RENDER_MODES,
    _colors_per_camera,
    expected_depth,
    rasterization,
    rasterize_screen,
    rasterize_surfels,
    tile_stream,
    with_depth_channel,
)

_RASTERIZERS = ("jax", "pallas", "packed", "packed_inference")
_RASTERIZERS_2DGS = ("jax", "packed", "packed_inference")


def _dense_capacity(isect_capacity: Optional[int], c_local: int, N: int) -> int:
    # the JAX sharded path's dense default (sharded_render.py:226)
    return isect_capacity or max(1 << 14, c_local * N * 4)


def _exchange(pieces, group):
    """Exchange [C, n, k_i] float32 pieces as one packed tensor → the
    pieces [C/D, N, k_i]."""
    widths = [p.shape[-1] for p in pieces]
    packed = torch.cat(pieces, dim=-1)
    got = comm.all_to_all(packed, group, split_axis=0, concat_axis=1)
    return list(torch.split(got, widths, dim=-1))


def _n_dropped(isect, device) -> torch.Tensor:
    return torch.tensor([int(isect.n_dropped)], dtype=torch.int32, device=device)


def rasterization_sharded(
    means,  # [n, 3] this rank's gaussian block
    quats,  # [n, 4]
    scales,  # [n, 3]
    opacities,  # [n]
    colors,  # [n, K, 3] SH, [n, D], or [C_col, n, D] per camera
    viewmats,  # [c, 4, 4] this rank's cameras
    Ks,  # [c, 3, 3]
    width: int,
    height: int,
    mesh: Mesh,
    axis_name: str = "gauss",
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    backgrounds=None,  # [c, D]
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    isect_capacity: Optional[int] = None,
    tile_capacity: int = 512,
    max_tiles_per_gauss: int = 32,
    rasterizer: str = "packed_inference",
    means2d_offset=None,  # [C_col, n, 2]
    means2d_abs_tap=None,  # [C_col, n, 2]
    camera_model: str = "pinhole",
    with_ut: bool = False,
    batch_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Render this rank's c cameras from the gaussians sharded over the
    mesh (``tdgs/parallel/sharded_render.py:51``) → (colors [c, H, W, X],
    alphas [c, H, W, 1], meta), X as ``rendering.rasterization`` gives it
    for ``render_mode``. Differentiable w.r.t. every gaussian input, the
    taps and per-camera colours; the gradients reach each gaussian's owner
    through the exchange. ``means2d_offset`` is the densification tap,
    added to the projected means before the exchange; the gradient of
    ``means2d_abs_tap`` (zeros) is the AbsGS |grad| sum (``"packed"`` and
    ``"jax"``). ``colors`` may be per-camera [C_col, n, D] (``sh_degree``
    None, the appearance module). ``rasterize_mode="antialiased"`` applies
    the projection's opacity compensation. ``with_ut`` is taken for the
    JAX signature and, as there, unused: the tiling projects by EWA. The
    default rasterizer is the port's forward-only kernel, as in
    ``rendering.rasterization`` (the JAX package's default is its plain
    ``"jax"`` reference)."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"rasterize_mode {rasterize_mode!r}")
    if rasterizer not in _RASTERIZERS:
        raise ValueError(f"unknown rasterizer {rasterizer!r}")
    if means2d_abs_tap is not None and rasterizer not in ("packed", "jax"):
        raise ValueError("means2d_abs_tap is supported by the 'jax' and 'packed' "
                         "rasterizers (differentiable paths)")
    dev = mesh.device
    means, quats, scales, opacities, colors, viewmats, Ks = (
        as_float(x, dev) for x in (means, quats, scales, opacities, colors, viewmats, Ks))
    backgrounds = as_optional_float(backgrounds, dev)
    group = mesh.group(axis_name)
    frame_group = None if batch_axis is None else mesh.group(batch_axis)
    colors_per_cam = sh_degree is None and colors.dim() == 3
    if frame_group is not None:
        # held alike along the frame axis: their gradients sum over it
        means, quats, scales, opacities = (
            comm.replicated(x, frame_group) for x in (means, quats, scales, opacities))
        if not colors_per_cam:
            colors = comm.replicated(colors, frame_group)
    depth_only = render_mode in ("D", "ED")

    # (1) the column's cameras
    viewmats_all = comm.all_gather(viewmats, group)
    Ks_all = comm.all_gather(Ks, group)
    # (2) project the local gaussians against them
    radii, means2d, depths, conics, compensations = fully_fused_projection(
        means, quats, scales, viewmats_all, Ks_all, width, height, eps2d=eps2d,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        calc_compensations=rasterize_mode == "antialiased", camera_model=camera_model,
        opacities=opacities)  # [C, n, ...]
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    C, n = radii.shape[:2]
    opac = opacities[None].expand(C, n)
    if compensations is not None:
        opac = opac * compensations
    # (3) exchange [C, n] → [c, N]
    pieces = [means2d, conics, opac[..., None], depths[..., None],
              radii.to(torch.float32)]
    if means2d_abs_tap is not None:
        pieces.append(means2d_abs_tap)
    if not depth_only:
        pieces.append(_colors_per_camera(colors, sh_degree, means, viewmats_all, radii))
    got = _exchange(pieces, group)
    means2d_l, conics_l, opac_l, depths_l, radii_l = got[:5]
    abs_tap_l = got[5] if means2d_abs_tap is not None else None
    cols_l = None if depth_only else got[-1]
    radii_l = radii_l.round().to(radii.dtype)
    depths_l, opac_l = depths_l[..., 0], opac_l[..., 0]
    c_local, N = radii_l.shape[:2]
    cols_l, bg = with_depth_channel(cols_l, depths_l, backgrounds, render_mode)

    # (4) the local cameras' stream and the rasterizer
    dense = rasterizer in ("jax", "pallas")
    isect, offsets, _ = tile_stream(
        means2d_l, radii_l, depths_l, tile_size, width, height, dense,
        _dense_capacity(isect_capacity, c_local, N) if dense else isect_capacity,
        max_tiles_per_gauss)
    abs_dummy = None if abs_tap_l is None else abs_tap_l.reshape(c_local * N, 2)
    img, alpha = rasterize_screen(
        rasterizer, means2d_l, conics_l, cols_l, opac_l, width, height, tile_size, offsets,
        isect, None if bg is None else bg.contiguous(), tile_capacity, abs_dummy)
    img = expected_depth(img, alpha, render_mode)
    meta = {"n_dropped": _n_dropped(isect, dev), "width": width, "height": height,
            "radii": radii, "means2d": means2d}
    return img, alpha, meta


def rasterization_2dgs_sharded(
    means,  # [n, 3] this rank's gaussian block
    quats,  # [n, 4]
    scales,  # [n, 3]
    opacities,  # [n]
    colors,  # [n, K, 3] SH or [n, D]
    viewmats,  # [c, 4, 4] this rank's cameras
    Ks,  # [c, 3, 3]
    width: int,
    height: int,
    mesh: Mesh,
    axis_name: str = "gauss",
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    backgrounds=None,  # [c, D]
    distloss: bool = False,
    render_mode: str = "RGB",
    isect_capacity: Optional[int] = None,
    tile_capacity: int = 512,
    max_tiles_per_gauss: int = 32,
    rasterizer: str = "packed_inference",
    means2d_offset=None,  # [C, n, 2]
    means2d_abs_tap=None,  # [C, n, 2]
) -> Tuple[torch.Tensor, ...]:
    """The surfel counterpart of :func:`rasterization_sharded`
    (``sharded_render.py:331``): the exchange ships the ray transform M (9
    values, read by its columns as the port's 2DGS rasterizers read it) and
    the camera-frame normals. Returns (colors [c, H, W, D], alphas,
    camera-frame normals [c, H, W, 3], distortion, median depth, meta);
    differentiable but for the median (the default ``"packed_inference"``
    is forward only). With ``distloss`` or "RGB+ED" a depth channel rides
    along; "RGB+ED" keeps it as expected depth."""
    if rasterizer not in _RASTERIZERS_2DGS:
        raise ValueError(f"unknown rasterizer {rasterizer!r}")
    if render_mode not in ("RGB", "RGB+ED"):
        raise ValueError(f"render_mode {render_mode!r} not in ('RGB', 'RGB+ED')")
    if means2d_abs_tap is not None and rasterizer not in ("packed", "jax"):
        raise ValueError("means2d_abs_tap is supported by the 'jax' and 'packed' "
                         "rasterizers (differentiable paths)")
    dev = mesh.device
    means, quats, scales, opacities, colors, viewmats, Ks = (
        as_float(x, dev) for x in (means, quats, scales, opacities, colors, viewmats, Ks))
    backgrounds = as_optional_float(backgrounds, dev)
    group = mesh.group(axis_name)
    need_depth = distloss or render_mode == "RGB+ED"

    viewmats_all = comm.all_gather(viewmats, group)
    Ks_all = comm.all_gather(Ks, group)
    radii, means2d, depths, M, normals = fully_fused_projection_2dgs(
        means, quats, scales, viewmats_all, Ks_all, width, height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip)  # [C, n, ...]
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    C, n = radii.shape[:2]
    pieces = [means2d, M.reshape(C, n, 9), normals, opacities[None].expand(C, n)[..., None],
              depths[..., None], radii.to(torch.float32)]
    if means2d_abs_tap is not None:
        pieces.append(means2d_abs_tap)
    pieces.append(_colors_per_camera(colors, sh_degree, means, viewmats_all, radii))
    got = _exchange(pieces, group)
    means2d_l, M_l, normals_l, opac_l, depths_l, radii_l = got[:6]
    abs_tap_l = got[6] if means2d_abs_tap is not None else None
    radii_l = radii_l.round().to(radii.dtype)
    c_local, N = radii_l.shape[:2]
    M_l = M_l.reshape(c_local, N, 3, 3)
    cols_l, bg = got[-1], backgrounds
    if need_depth:
        cols_l, bg = with_depth_channel(cols_l, depths_l[..., 0], bg, "RGB+D")

    dense = rasterizer == "jax"
    isect, offsets, _ = tile_stream(
        means2d_l, radii_l, depths_l[..., 0], tile_size, width, height, dense,
        _dense_capacity(isect_capacity, c_local, N) if dense else isect_capacity,
        max_tiles_per_gauss)
    abs_dummy = None if abs_tap_l is None else abs_tap_l.reshape(c_local * N, 2)
    img, alpha, nrm, dist, med = rasterize_surfels(
        rasterizer, means2d_l, M_l, cols_l, normals_l, opac_l[..., 0], width, height,
        tile_size, offsets, isect, bg, tile_capacity, need_depth, distloss, abs_dummy)
    if render_mode == "RGB+ED":
        img = expected_depth(img, alpha, render_mode)
    elif need_depth:
        img = img[..., :-1]  # the depth channel rode along for distortion only
    meta = {"n_dropped": _n_dropped(isect, dev), "width": width, "height": height,
            "radii": radii, "means2d": means2d}
    return img, alpha, nrm, dist, med, meta


def rasterization_eval3d_sharded(
    means,  # [n, 3] this rank's gaussian block
    quats,  # [n, 4]
    scales,  # [n, 3]
    opacities,  # [n]
    colors,  # [n, K, 3] SH, [n, D], or [C, n, D] per camera
    viewmats,  # [c, 4, 4] this rank's cameras
    Ks,  # [c, 3, 3]
    width: int,
    height: int,
    mesh: Mesh,
    axis_name: str = "gauss",
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    backgrounds=None,  # [c, D]
    camera_model: str = "pinhole",
    isect_capacity: Optional[int] = None,
    tile_capacity: int = 512,
    max_tiles_per_gauss: int = 32,
    with_ut: bool = False,
    radial_coeffs=None,  # [c, 6|4]
    tangential_coeffs=None,  # [c, 2]
    thin_prism_coeffs=None,  # [c, 4]
    ftheta_coeffs=None,  # FThetaCameraDistortionParameters
    rolling_shutter=None,  # RollingShutterType
    viewmats_rs=None,  # [c, 4, 4]
    render_mode: str = "RGB",
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """World-space (eval3d, 3DGUT) sharded rendering
    (``sharded_render.py:545``): the exchange ships each (camera, gaussian)
    feature row of the port's eval3d rasterizer (M = diag(1/s)·Rᵀ, g0 =
    M(o_ref − μ), opacity, colours with the depth channels of
    ``render_mode``), and each rank builds its tiles' world rays locally
    after the exchange (distortion and rolling shutter included), so the
    rays need no collective. The tiling projects through the unscented
    transform when the camera bends rays. Kernels 7 and 8 take σ* in the
    port's stable cross form. Differentiable w.r.t. every gaussian input
    and the camera poses (``viewmats``, ``viewmats_rs``)."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode {render_mode!r} not in {RENDER_MODES}")
    dev = mesh.device
    means, quats, scales, opacities, colors, viewmats, Ks = (
        as_float(x, dev) for x in (means, quats, scales, opacities, colors, viewmats, Ks))
    backgrounds = as_optional_float(backgrounds, dev)
    radial_coeffs, tangential_coeffs, thin_prism_coeffs, viewmats_rs = (
        as_optional_float(x, dev)
        for x in (radial_coeffs, tangential_coeffs, thin_prism_coeffs, viewmats_rs))
    rolling_shutter = RollingShutterType(rolling_shutter or RollingShutterType.GLOBAL)
    group = mesh.group(axis_name)
    use_rs = viewmats_rs is not None and rolling_shutter != RollingShutterType.GLOBAL
    use_ut = (with_ut or camera_model != "pinhole" or use_rs or any(
        c is not None for c in (radial_coeffs, tangential_coeffs, thin_prism_coeffs)))

    def gather(x):
        return None if x is None else comm.all_gather(x, group)

    viewmats_all, Ks_all = gather(viewmats), gather(Ks)
    if use_ut:
        # the projection only tiles unless its depths are a colour channel
        project = (project_ut_for_tiles if render_mode == "RGB"
                   else fully_fused_projection_with_ut)
        radii, means2d, depths, _, _ = project(
            means, quats, scales, opacities, viewmats_all, Ks_all, width, height,
            eps2d=eps2d, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, camera_model=camera_model,
            radial_coeffs=gather(radial_coeffs), tangential_coeffs=gather(tangential_coeffs),
            thin_prism_coeffs=gather(thin_prism_coeffs), ftheta_coeffs=ftheta_coeffs,
            rolling_shutter=rolling_shutter, viewmats_rs=gather(viewmats_rs))
    else:
        radii, means2d, depths, _, _ = fully_fused_projection(
            means, quats, scales, viewmats_all, Ks_all, width, height, eps2d=eps2d,
            near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
            opacities=opacities)  # [C, n, ...]
    C, n = radii.shape[:2]
    cols = _colors_per_camera(colors, sh_degree, means, viewmats_all, radii)
    cols, bg = with_depth_channel(cols, depths, backgrounds, render_mode)
    D_ch = cols.shape[-1]
    # the feature rows against every camera of the column (start-pose
    # centres o_ref = −Rᵀt, as tile_rays_world takes them)
    R_wc, t_wc = viewmats_all[:, :3, :3], viewmats_all[:, :3, 3]
    o_ref = -(R_wc.transpose(1, 2) @ t_wc[..., None])[..., 0]
    feats = feature_rows(means, quats, scales, opacities[None].expand(C, n), cols, o_ref)
    got = _exchange([means2d, radii.to(torch.float32), depths[..., None],
                     feats.reshape(C, n, -1)], group)
    means2d_l, radii_l, depths_l, feats_l = got
    radii_l = radii_l.round().to(radii.dtype)
    c_local, N = radii_l.shape[:2]

    tile_width = math.ceil(width / tile_size)
    tile_height = math.ceil(height / tile_size)
    isect, _, _ = tile_stream(means2d_l, radii_l, depths_l[..., 0], tile_size, width, height,
                              False, isect_capacity, max_tiles_per_gauss)
    d, o, _ = tile_rays_world(
        c_local, tile_width, tile_height, tile_size, width, height, viewmats, Ks,
        camera_model, radial_coeffs, tangential_coeffs, thin_prism_coeffs, ftheta_coeffs,
        rolling_shutter, viewmats_rs)
    img, alpha = rasterize_feature_rows(
        feats_l.reshape(c_local * N, -1), d, o, isect.offsets, isect.flatten_ids, c_local,
        D_ch, width, height, tile_size, bg, tile_capacity)
    img = expected_depth(img, alpha, render_mode)
    meta = {"n_dropped": _n_dropped(isect, dev), "width": width, "height": height,
            "radii": radii, "means2d": means2d}
    return img, alpha, meta


def rasterization_replicated(
    means,  # [N, 3] every gaussian, on every rank
    quats,
    scales,
    opacities,
    colors,
    viewmats,  # [c, 4, 4] this rank's cameras
    Ks,  # [c, 3, 3]
    width: int,
    height: int,
    mesh: Mesh,
    axis_name: str = "gauss",
    backgrounds=None,  # [c, D]
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Frame-parallel rendering (``sharded_render.py:845``): the gaussians
    whole on every rank, the cameras sharded; each rank renders its own
    through ``rendering.rasterization`` (any rasterizer, render mode or
    camera keyword passes through). No collective."""
    if quats is None or scales is None:
        raise ValueError("replicated rendering takes quats/scales (covars mode: use the "
                         "single-device path)")
    del axis_name
    img, alpha, meta = rasterization(means, quats, scales, opacities, colors, viewmats, Ks,
                                     width, height, backgrounds=backgrounds,
                                     device=mesh.device, **kwargs)
    return img, alpha, {"n_dropped": torch.tensor([int(meta.get("n_dropped", 0))],
                                                  dtype=torch.int32, device=mesh.device),
                        "width": width, "height": height}
