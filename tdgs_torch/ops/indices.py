"""Index rasterization and compositing over explicit intersection lists
(port of ``tdgs/ops/indices.py``, the reference's slow debugging path).

``rasterize_to_indices_in_range`` emits the (gaussian, pixel, image)
intersections of a depth-sorted batch range of each tile's entries,
resumable through the per-pixel transmittance reached before the range;
``accumulate`` alpha-composites such lists, differentiable by autograd.
The lists have a fixed length with a validity mask, as the JAX package
returns them. Plain tensor ops over the port's dense tiling
(``rasterize_jax.gather_tile_gaussians``); no kernel.

The 2DGS variants take the ray transform's columns, as the port's 2DGS
rasterizers do (the JAX package reads M's rows, the transposed matrix; see
ROADMAP, faults on the reference side).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.rasterize_jax import ALPHA_CLAMP, TRANSMITTANCE_EPS, gather_tile_gaussians


def _tile_pixels(gauss_ids, tile_width: int, tile_height: int, tile_size: int):
    """(tile's image [T], pixel centres px, py [T, tile_size²]) of the
    gathered tiles."""
    dev = gauss_ids.device
    tids = torch.arange(gauss_ids.shape[0], dtype=torch.int32, device=dev)
    t_in_img = tids % (tile_width * tile_height)
    img_of_tile = tids // (tile_width * tile_height)
    tx = (t_in_img % tile_width) * tile_size
    ty = (t_in_img // tile_width) * tile_size
    p = torch.arange(tile_size * tile_size, dtype=torch.int32, device=dev)
    px = (tx[:, None] + p[None, :] % tile_size).to(torch.float32) + 0.5
    py = (ty[:, None] + p[None, :] // tile_size).to(torch.float32) + 0.5
    return img_of_tile, px, py


def _range_entries(range_start, range_end, isect_offsets, flatten_ids, n_isects, I,
                   tile_size):
    """The entries [range_start·B, range_end·B) of each tile (B = its
    pixel count): (gaussian ids [T, cap] into the [I·N] rows, in-tile
    mask)."""
    th, tw = isect_offsets.shape[-2:]
    block = tile_size * tile_size
    s0 = range_start * block
    cap = (range_end - range_start) * block
    gauss_ids, in_tile = gather_tile_gaussians(
        isect_offsets.reshape(I, th, tw), flatten_ids, n_isects, s0 + cap)
    return gauss_ids[:, s0:], in_tile[:, s0:]


def _index_lists(alpha, live, gauss_ids, img_of_tile, px, py, transmittances, N, I,
                 image_width, image_height):
    """The lists of the entries whose running transmittance, resumed from
    ``transmittances``, stays above 1e-4 → (gaussian_ids, pixel_ids,
    image_ids, valid), flattened over [T, P, cap]."""
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    trans = transmittances.reshape(I, image_height, image_width)
    pix_x = torch.clamp(px.to(torch.int32), 0, image_width - 1).long()
    pix_y = torch.clamp(py.to(torch.int32), 0, image_height - 1).long()
    T_in = trans[img_of_tile.long()[:, None], pix_y, pix_x]  # [T, P]
    P_raw = T_in[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
    included = (P_raw > TRANSMITTANCE_EPS) & live

    pix_id = (pix_y * image_width + pix_x).to(torch.int32)  # [T, P]
    shape = included.shape
    out_g = gauss_ids[:, None, :].expand(shape)
    out_p = pix_id[..., None].expand(shape)
    out_i = img_of_tile[:, None, None].expand(shape).to(torch.int32)
    # inside-image filter for boundary tiles
    inside = (px < image_width)[:, :, None] & (py < image_height)[:, :, None]
    valid = included & inside
    return ((out_g % N).reshape(-1), out_p.reshape(-1), out_i.reshape(-1),
            valid.reshape(-1))


def rasterize_to_indices_in_range(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [..., H, W] current per-pixel T
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [..., tile_height, tile_width]
    flatten_ids: torch.Tensor,  # [capacity]
    n_isects,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gaussian_ids, pixel_ids, image_ids, valid): the flattened
    per-(tile, pixel, slot) intersection lists for the entry batches
    [range_start·B, range_end·B) of each tile (B = tile_size²), with only
    the contributions where α ≥ 1/255 and the running T stays above
    1e-4."""
    image_dims = tuple(means2d.shape[:-2])
    N = means2d.shape[-2]
    I = math.prod(image_dims) if image_dims else 1
    th, tw = isect_offsets.shape[-2:]
    gauss_ids, in_tile = _range_entries(range_start, range_end, isect_offsets, flatten_ids,
                                        n_isects, I, tile_size)
    g_means = means2d.reshape(I * N, 2)[gauss_ids]  # [T, cap, 2]
    g_conics = conics.reshape(I * N, 3)[gauss_ids]
    g_opac = opacities.reshape(I * N)[gauss_ids]
    img_of_tile, px, py = _tile_pixels(gauss_ids, tw, th, tile_size)

    dx = g_means[:, None, :, 0] - px[:, :, None]  # [T, P, cap]
    dy = g_means[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = (g_conics[:, None, :, i] for i in range(3))
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.clamp(g_opac[:, None, :] * torch.exp(-sigma), max=ALPHA_CLAMP)
    live = ~((sigma < 0.0) | (alpha < ALPHA_THRESHOLD) | ~in_tile[:, None, :])
    return _index_lists(alpha, live, gauss_ids, img_of_tile, px, py, transmittances, N, I,
                        image_width, image_height)


def _sigma_2dgs(M, means2d, px, py):
    """The 2DGS ray-splat σ of ray transforms ``M`` [..., 3, 3] at pixel
    centres ``px``/``py`` [...]: ½·min(u² + v², 2|p − mean2d|²), with
    (u, v) from the planes of M's columns."""
    h_u = -M[..., :, 0] + M[..., :, 2] * px[..., None]
    h_v = -M[..., :, 1] + M[..., :, 2] * py[..., None]
    tmp = torch.linalg.cross(h_u, h_v, dim=-1)
    bad = torch.abs(tmp[..., 2]) < 1e-9
    tz = torch.where(bad, torch.ones_like(tmp[..., 2]), tmp[..., 2])
    us = tmp[..., 0] / tz
    vs = tmp[..., 1] / tz
    sigma3d = torch.where(bad, torch.full_like(us, 1e6), us * us + vs * vs)
    dx = px - means2d[..., 0]
    dy = py - means2d[..., 1]
    sigma2d = 2.0 * (dx * dx + dy * dy)
    return 0.5 * torch.minimum(sigma3d, sigma2d)


def rasterize_to_indices_in_range_2dgs(
    range_start: int,
    range_end: int,
    transmittances: torch.Tensor,  # [..., H, W]
    means2d: torch.Tensor,  # [..., N, 2]
    ray_transforms: torch.Tensor,  # [..., N, 3, 3]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [..., tile_height, tile_width]
    flatten_ids: torch.Tensor,  # [capacity]
    n_isects,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 2DGS variant of :func:`rasterize_to_indices_in_range`: the same
    batching and cutoffs, σ from the surfels' ray transforms."""
    image_dims = tuple(means2d.shape[:-2])
    N = means2d.shape[-2]
    I = math.prod(image_dims) if image_dims else 1
    th, tw = isect_offsets.shape[-2:]
    gauss_ids, in_tile = _range_entries(range_start, range_end, isect_offsets, flatten_ids,
                                        n_isects, I, tile_size)
    g_means = means2d.reshape(I * N, 2)[gauss_ids]  # [T, cap, 2]
    g_M = ray_transforms.reshape(I * N, 3, 3)[gauss_ids]  # [T, cap, 3, 3]
    g_opac = opacities.reshape(I * N)[gauss_ids]
    img_of_tile, px, py = _tile_pixels(gauss_ids, tw, th, tile_size)

    sigma = _sigma_2dgs(g_M[:, None], g_means[:, None], px[:, :, None], py[:, :, None])
    alpha = torch.clamp(g_opac[:, None, :] * torch.exp(-sigma), max=ALPHA_CLAMP)
    live = ~((alpha < ALPHA_THRESHOLD) | ~in_tile[:, None, :])
    return _index_lists(alpha, live, gauss_ids, img_of_tile, px, py, transmittances, N, I,
                        image_width, image_height)


def _composite_lists(alpha, colors_f, pixel_ids, image_ids, image_dims, I,
                     image_width, image_height):
    """Compositing of lists that are depth-ordered within each pixel: a
    stable sort by ray, then each entry's transmittance as the exclusive
    prefix sum of log(1 − α) within its ray's segment → (renders [...,
    H, W, D], alphas [..., H, W, 1]). The segment's prefix is the
    difference of two prefix sums over the whole list, taken in float64:
    in float32 (the JAX package's) it loses about ulp(|Σ log(1 − α)|) of
    the list, 2e-4 at 200k entries (ROADMAP, faults on the reference
    side)."""
    M = alpha.shape[0]
    D = colors_f.shape[-1]
    dev = alpha.device
    ray = (image_ids.long() * image_height * image_width + pixel_ids.long())
    order = torch.argsort(ray, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(M, device=dev)
    a_sorted = alpha[order]
    r_sorted = ray[order]
    logs = torch.log1p(-a_sorted).double()
    cum = torch.cumsum(logs, dim=0)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           r_sorted[1:] != r_sorted[:-1]])
    idxs = torch.arange(M, dtype=torch.int64, device=dev)
    start_pos = torch.cummax(torch.where(seg_start, idxs, torch.full_like(idxs, -1)),
                             dim=0).values
    excl = cum - logs
    T_prev = torch.exp(excl - excl[torch.clamp(start_pos, min=0)]).to(alpha.dtype)
    weights = (a_sorted * T_prev)[inv]

    total_px = I * image_height * image_width
    renders = torch.zeros((total_px, D), dtype=colors_f.dtype, device=dev).index_add(
        0, ray, weights[:, None] * colors_f)
    alphas = torch.zeros((total_px,), dtype=alpha.dtype, device=dev).index_add(0, ray, weights)
    return (renders.reshape(image_dims + (image_height, image_width, D)),
            alphas.reshape(image_dims + (image_height, image_width, 1)))


def _list_rows(image_ids, gaussian_ids, N, I, *arrays):
    """Each array [..., N, k...] flattened over its images and gathered at
    the lists' (image, gaussian) rows."""
    flat_g = image_ids.long() * N + gaussian_ids.long()
    return [a.reshape((I * N,) + tuple(a.shape[len(a.shape) - k:]))[flat_g]
            for a, k in arrays]


def accumulate(
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    colors: torch.Tensor,  # [..., N, D]
    gaussian_ids: torch.Tensor,  # [M]
    pixel_ids: torch.Tensor,  # [M]
    image_ids: torch.Tensor,  # [M]
    image_width: int,
    image_height: int,
    valid: Optional[torch.Tensor] = None,  # [M]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alpha compositing over explicit (gaussian, pixel, image) lists (the
    reference's ``accumulate``) → (renders [..., H, W, D], alphas [..., H,
    W, 1]). The lists must be depth-ordered within each pixel, as the index
    rasterizer emits them; entries outside ``valid`` count for nothing.
    Differentiable by autograd."""
    image_dims = tuple(means2d.shape[:-2])
    I = math.prod(image_dims) if image_dims else 1
    N = means2d.shape[-2]
    means2d_f, conics_f, opac_f, colors_f = _list_rows(
        image_ids, gaussian_ids, N, I, (means2d, 1), (conics, 1), (opacities, 0), (colors, 1))

    px = (pixel_ids % image_width).to(torch.float32) + 0.5
    py = (pixel_ids // image_width).to(torch.float32) + 0.5
    dx = means2d_f[:, 0] - px
    dy = means2d_f[:, 1] - py
    sigma = 0.5 * (conics_f[:, 0] * dx * dx + conics_f[:, 2] * dy * dy) + conics_f[:, 1] * dx * dy
    alpha = torch.clamp(opac_f * torch.exp(-sigma), max=ALPHA_CLAMP)
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return _composite_lists(alpha, colors_f, pixel_ids, image_ids, image_dims, I,
                            image_width, image_height)


def accumulate_2dgs(
    means2d: torch.Tensor,  # [..., N, 2]
    ray_transforms: torch.Tensor,  # [..., N, 3, 3]
    opacities: torch.Tensor,  # [..., N]
    colors: torch.Tensor,  # [..., N, D]
    gaussian_ids: torch.Tensor,  # [M]
    pixel_ids: torch.Tensor,  # [M]
    image_ids: torch.Tensor,  # [M]
    image_width: int,
    image_height: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2DGS compositing over explicit intersection lists (the reference's
    ``accumulate_2dgs``): :func:`accumulate` with the surfels' σ."""
    image_dims = tuple(means2d.shape[:-2])
    I = math.prod(image_dims) if image_dims else 1
    N = means2d.shape[-2]
    means2d_f, M_f, opac_f, colors_f = _list_rows(
        image_ids, gaussian_ids, N, I, (means2d, 1), (ray_transforms, 2), (opacities, 0),
        (colors, 1))

    px = (pixel_ids % image_width).to(torch.float32) + 0.5
    py = (pixel_ids // image_width).to(torch.float32) + 0.5
    sigma = _sigma_2dgs(M_f, means2d_f, px, py)
    alpha = torch.clamp(opac_f * torch.exp(-sigma), max=ALPHA_CLAMP)
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return _composite_lists(alpha, colors_f, pixel_ids, image_ids, image_dims, I,
                            image_width, image_height)
