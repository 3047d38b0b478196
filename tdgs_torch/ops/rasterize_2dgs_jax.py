"""The dense 2DGS (surfel) tile rasterizer in plain tensor ops (port of
``tdgs/ops/rasterize_2dgs_jax.py``, the JAX package's 2DGS
``rasterizer="jax"``).

Each tile gathers its first ``tile_capacity`` entries into a dense
[tiles, capacity] block (``gather_tile_gaussians``) and every pixel of the
tile intersects its ray with each surfel: with T0, T1, T2 the screen-space
rows of K [RS_u, RS_v, mean_c], which are the columns of the projection's
ray transform M, the planes h_u = px·T2 − T0 and h_v = py·T2 − T1 meet in
(u, v, 1) ∝ h_u × h_v = T0×T1 + px·(T1×T2) + py·(T2×T0), as kernels 4–6
take it. (The JAX package reads M's rows, the transposed matrix; see
ROADMAP, faults on the reference side.) σ = ½·min(u² + v², 2|p − mean2d|²),
and the block composites as a prefix product (``composite_prefix``'s
rule) into colours, camera-frame normals, the Mip-NeRF 360 distortion of
the last colour channel (the depth) and the median depth. Autograd
differentiates it through the tensor ops; the median's depth value carries
a gradient, its choice of entry none. It holds [tiles, pixels, capacity]
arrays, so it is meant for small scenes, tests, image fitting and as an
independent reference of kernels 5 and 6.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.rasterize_jax import (
    ALPHA_CLAMP,
    TRANSMITTANCE_EPS,
    absgrad_tap,
    gather_tile_gaussians,
)
from tdgs_torch.ops.rasterize_packed import untile

TMPZ_EPS = 1e-9
SIGMA_BAD = 1e6


def rasterize_to_pixels_2dgs_jax(
    means2d: torch.Tensor,  # [..., N, 2]
    ray_transforms: torch.Tensor,  # [..., N, 3, 3]
    colors: torch.Tensor,  # [..., N, D] (last channel the depth with distortion)
    normals: torch.Tensor,  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [..., tile_height, tile_width]
    flatten_ids: torch.Tensor,  # [capacity]
    n_isects,  # int or 0-d tensor
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 512,
    compute_distort: bool = False,
    absgrad_dummy: Optional[torch.Tensor] = None,  # [I*N, 2] zeros
) -> Tuple[torch.Tensor, ...]:
    """Returns (render_colors [..., H, W, D], render_alphas [..., H, W, 1],
    render_normals [..., H, W, 3] (camera frame), render_distort
    [..., H, W, 1] (zeros unless ``compute_distort``), render_median
    [..., H, W, 1]). ``absgrad_dummy``: zeros whose gradient is the
    per-gaussian sum of |per-tile screen-space gradients| (AbsGS)."""
    image_dims = tuple(means2d.shape[:-2])
    N = means2d.shape[-2]
    D = colors.shape[-1]
    I = math.prod(image_dims) if image_dims else 1
    tile_height, tile_width = isect_offsets.shape[-2:]
    device = means2d.device

    gauss_ids, valid = gather_tile_gaussians(
        isect_offsets.reshape(I, tile_height, tile_width), flatten_ids, n_isects,
        tile_capacity)  # [T, cap]
    T_total = gauss_ids.shape[0]
    ids = gauss_ids.to(torch.int64)
    g_means = means2d.reshape(I * N, 2)[ids]  # [T, cap, 2]
    if absgrad_dummy is not None:
        g_means = absgrad_tap(g_means, absgrad_dummy, gauss_ids, valid)
    # the screen-space rows T_j are M's columns
    Tm = ray_transforms.reshape(I * N, 3, 3).transpose(1, 2)[ids]  # [T, cap, 3 (j), 3]
    t0 = torch.linalg.cross(Tm[..., 0, :], Tm[..., 1, :], dim=-1)  # [T, cap, 3]
    tpx = torch.linalg.cross(Tm[..., 1, :], Tm[..., 2, :], dim=-1)
    tpy = torch.linalg.cross(Tm[..., 2, :], Tm[..., 0, :], dim=-1)
    g_colors = colors.reshape(I * N, D)[ids]
    g_normals = normals.reshape(I * N, 3)[ids]
    g_opac = opacities.reshape(I * N)[ids]

    t_in_img = torch.arange(T_total, device=device) % (tile_height * tile_width)
    tx = (t_in_img % tile_width) * tile_size
    ty = (t_in_img // tile_width) * tile_size
    p = torch.arange(tile_size * tile_size, device=device)
    px = ((tx[:, None] + p[None, :] % tile_size).to(torch.float32) + 0.5)[:, :, None]
    py = ((ty[:, None] + p[None, :] // tile_size).to(torch.float32) + 0.5)[:, :, None]

    # (u, v, 1)·tmpz = h_u × h_v, per (tile, pixel, entry), in the kernels'
    # order of operations (rasterize_2dgs_common.cuh), so that an α near
    # 1/255 lands on the same side here and in kernels 4–6
    tmpx, tmpy, tmpz = (t0[:, None, :, i] + tpx[:, None, :, i] * px
                        + tpy[:, None, :, i] * py for i in range(3))
    bad = tmpz.abs() < TMPZ_EPS
    rtz = 1.0 / torch.where(bad, torch.ones_like(tmpz), tmpz)
    sigma3d = torch.where(bad, torch.full_like(tmpz, SIGMA_BAD),
                          (tmpx * tmpx + tmpy * tmpy) * (rtz * rtz))
    dx = g_means[:, None, :, 0] - px
    dy = g_means[:, None, :, 1] - py
    sigma = 0.5 * torch.minimum(sigma3d, 2.0 * (dx * dx + dy * dy))  # [T, P, cap]

    alpha = torch.clamp(g_opac[:, None, :] * torch.exp(-sigma), max=ALPHA_CLAMP)
    skip = (alpha < ALPHA_THRESHOLD) | ~valid[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

    one_minus = 1.0 - alpha
    Pcum = torch.cumprod(one_minus, dim=-1)
    included = Pcum > TRANSMITTANCE_EPS
    T_prev = Pcum / one_minus
    w = torch.where(included, alpha * T_prev, torch.zeros_like(alpha))
    T_out = torch.where(included, one_minus, torch.ones_like(one_minus)).prod(dim=-1)
    rendered = torch.einsum("tpk,tkd->tpd", w, g_colors)
    rnormal = torch.einsum("tpk,tkd->tpd", w, g_normals)

    # distortion 2 Σ_i w_i (d_i·A_i − B_i), A and B the exclusive prefix
    # sums of w and w·d (d the last colour channel)
    depth = g_colors[..., -1][:, None, :].expand_as(w)
    A_excl = torch.cumsum(w, dim=-1) - w
    B_excl = torch.cumsum(w * depth, dim=-1) - w * depth
    distort = (2.0 * w * (depth * A_excl - B_excl)).sum(-1)
    if not compute_distort:
        distort = torch.zeros_like(distort)

    # the median: the depth of the last entry with T_prev > 0.5 and w > 0
    lane = torch.arange(w.shape[-1], device=device)
    last = torch.where((T_prev > 0.5) & (w > 0.0), lane, -1).amax(-1)  # [T, P]
    med = torch.gather(depth, -1, last.clamp(min=0)[..., None])[..., 0]
    med = torch.where(last >= 0, med, torch.zeros_like(med))

    args = (I, tile_width, tile_height, tile_size, image_height, image_width)
    img = untile(rendered, *args)
    nrm = untile(rnormal, *args)
    alp = 1.0 - untile(T_out[..., None], *args)
    dst = untile(distort[..., None], *args)
    mdn = untile(med[..., None], *args)
    if backgrounds is not None:
        img = img + (1.0 - alp) * backgrounds.reshape(I, 1, 1, D)
    shp = image_dims + (image_height, image_width)
    return (img.reshape(shp + (D,)), alp.reshape(shp + (1,)), nrm.reshape(shp + (3,)),
            dst.reshape(shp + (1,)), mdn.reshape(shp + (1,)))
