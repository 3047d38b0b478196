"""The dense tile rasterizer in plain tensor ops (port of
``tdgs/ops/rasterize_jax.py``, the JAX package's jnp oracle: its
``rasterizer="jax"``).

Each tile gathers its first ``tile_capacity`` sorted entries into a dense
[tiles, capacity] block (``gather_tile_gaussians``); every pixel of the tile
then composites the whole block as a prefix product
(``composite_prefix``): P_k = ∏_{j≤k}(1 − α_j), entry k is included iff
P_k > 1e-4, its weight is α_k·P_{k−1}. Autograd differentiates it through
the tensor ops, as ``jax.grad`` differentiates the jnp version; there is no
kernel here. It is the plain form of kernels 9 and 10
(``tdgs_torch/ops/rasterize_pallas.py``), and it holds [tiles, pixels,
capacity] arrays, so it is meant for small scenes and tests.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.rasterize_packed import untile
from tdgs_torch.ops.segment_sum import segment_rows_sum, sort_ids

TRANSMITTANCE_EPS = 1e-4  # pixel-done cutoff
ALPHA_CLAMP = 0.999


class _AbsgradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, abs_dummy, entry_ids, entry_valid):
        ctx.save_for_backward(entry_ids, entry_valid)
        ctx.n_rows = abs_dummy.shape[0]
        return values.clone()

    @staticmethod
    def backward(ctx, v):
        entry_ids, entry_valid = ctx.saved_tensors
        sids, perm = sort_ids(entry_ids.reshape(-1), mask=entry_valid.reshape(-1))
        acc = segment_rows_sum(v[..., 0:2].abs().reshape(-1, 2).contiguous(), perm, sids,
                               ctx.n_rows)
        return v, acc, None, None


def absgrad_tap(values, abs_dummy, entry_ids, entry_valid):
    """Identity on ``values`` [..., E, F] whose gradient w.r.t.
    ``abs_dummy`` [M, 2] is the per-gaussian sum of |∂/∂ values[..., 0:2]|
    over the valid entries (port of ``tdgs/ops/rasterize_jax.py:40``: the
    AbsGS signal, |·| per tile entry). The sum is a stable sort of the
    valid ``entry_ids`` and the segment sum (kernel 3 on the card), so it
    is deterministic."""
    return _AbsgradTap.apply(values, abs_dummy, entry_ids, entry_valid)


def gather_tile_gaussians(
    isect_offsets: torch.Tensor,  # [I, tile_height, tile_width] int32
    flatten_ids: torch.Tensor,  # [capacity] int32
    n_isects,  # int or 0-d tensor
    tile_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile gaussian ids at fixed capacity (port of
    ``tdgs/ops/rasterize_jax.py:80``): (gauss_ids [n_tiles, tile_capacity]
    int32 into the flattened [I·N] gaussians, valid mask). A tile with more
    entries keeps its nearest ``tile_capacity``; invalid slots hold the id
    at the clamped stream position."""
    offsets_flat = isect_offsets.reshape(-1).to(torch.int64)
    n = torch.as_tensor(n_isects, dtype=torch.int64, device=offsets_flat.device)
    ends = torch.cat([offsets_flat[1:], n.reshape(1)])
    idx = offsets_flat[:, None] + torch.arange(tile_capacity, device=offsets_flat.device)
    valid = idx < ends[:, None]
    idx = torch.clamp(idx, max=flatten_ids.shape[0] - 1)
    return flatten_ids[idx], valid


def composite_prefix(
    alphas: torch.Tensor,  # [..., K], already masked and clamped
    colors: torch.Tensor,  # [..., K, D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Front-to-back compositing as a prefix product (port of
    ``tdgs/ops/rasterize_jax.py:104``): (rendered [..., D], final
    transmittance [...], weights [..., K])."""
    one_minus = 1.0 - alphas
    P = torch.cumprod(one_minus, dim=-1)
    included = P > TRANSMITTANCE_EPS
    T_prev = P / one_minus  # α ≤ 0.999, so 1 − α ≥ 1e-3
    weights = torch.where(included, alphas * T_prev, torch.zeros_like(alphas))
    rendered = torch.einsum("...k,...kd->...d", weights, colors)
    T_out = torch.where(included, one_minus, torch.ones_like(one_minus)).prod(dim=-1)
    return rendered, T_out, weights


def rasterize_to_pixels_jax(
    means2d: torch.Tensor,  # [..., N, 2]
    conics: torch.Tensor,  # [..., N, 3]
    colors: torch.Tensor,  # [..., N, D]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [..., tile_height, tile_width]
    flatten_ids: torch.Tensor,  # [capacity]
    n_isects,  # int or 0-d tensor
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
    absgrad_dummy: Optional[torch.Tensor] = None,  # [I*N, 2] zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterize to pixels with plain tensor ops, differentiable by
    autograd (port of ``tdgs/ops/rasterize_jax.py:122``). Returns
    (render_colors [..., H, W, D], render_alphas [..., H, W, 1]).
    ``absgrad_dummy``: zeros whose gradient is the per-gaussian sum of
    |per-tile screen-space gradients| (``absgrad_tap``)."""
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
    g_conics = conics.reshape(I * N, 3)[ids]
    g_colors = colors.reshape(I * N, D)[ids]
    g_opac = opacities.reshape(I * N)[ids]

    # pixel centres of every tile: [T, P]
    t_in_img = torch.arange(T_total, device=device) % (tile_height * tile_width)
    tx = (t_in_img % tile_width) * tile_size
    ty = (t_in_img // tile_width) * tile_size
    p = torch.arange(tile_size * tile_size, device=device)
    px = (tx[:, None] + p[None, :] % tile_size).to(torch.float32) + 0.5
    py = (ty[:, None] + p[None, :] // tile_size).to(torch.float32) + 0.5

    dx = g_means[:, None, :, 0] - px[:, :, None]  # [T, P, cap]
    dy = g_means[:, None, :, 1] - py[:, :, None]
    ca = g_conics[:, None, :, 0]
    cb = g_conics[:, None, :, 1]
    cc = g_conics[:, None, :, 2]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.clamp(g_opac[:, None, :] * torch.exp(-sigma), max=ALPHA_CLAMP)
    skip = (sigma < 0.0) | (alpha < ALPHA_THRESHOLD) | ~valid[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

    rendered, T_out, _ = composite_prefix(alpha, g_colors[:, None, :, :])  # [T, P, D], [T, P]

    args = (I, tile_width, tile_height, tile_size, image_height, image_width)
    img = untile(rendered, *args)
    alp = 1.0 - untile(T_out[..., None], *args)[..., 0]
    if backgrounds is not None:
        img = img + (1.0 - alp[..., None]) * backgrounds.reshape(I, 1, 1, D)
    return (img.reshape(image_dims + (image_height, image_width, D)),
            alp.reshape(image_dims + (image_height, image_width, 1)))
