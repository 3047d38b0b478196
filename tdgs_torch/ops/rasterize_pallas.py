"""The tile-dense rasterizer (port of ``tdgs/ops/rasterize_pallas.py``: its
``rasterize_to_pixels_pallas`` :399, the API's ``rasterizer="pallas"``).

As in the JAX package, the per-tile gather stays a tensor op: each tile's
first ``tile_capacity`` sorted entries are gathered into dense rows
``[tiles, capacity, 6 + D]`` = (mx, my, a, b, c, opacity, colours) through
``gather_rows_segsum``, whose VJP is a sort of the valid slots and the
segment sum (kernel 3), deterministic and without atomics. The compositing
runs in hand-written CUDA kernels for CUDA tensors and in the plain
PyTorch versions below for CPU tensors, behind an autograd Function:

- kernel 9, ``tdgs_torch/csrc/rasterize_dense_fwd.cu`` (replaces
  ``_fwd_kernel`` :99): per tile, the valid slots front to back, α clamp
  0.999, the 1/255 skip, slot k included iff the raw prefix product
  ∏_{j≤k}(1 − α_j) is above 1e-4; it writes the colours without
  background and the transmittance T;
- kernel 10, ``tdgs_torch/csrc/rasterize_dense_bwd.cu`` (replaces
  ``_bwd_kernel`` :168): per (tile, slot) the gradient row, summed over
  the tile's pixels; zero for slots past the tile's count or cutoff.

Where tiles are few (image fitting's 64), each tile goes to several blocks
(``split_count``, from the card's SM count): kernel 9 splits its pixels'
warps among them, kernel 10 its slots into ranges. The outputs are bitwise
those of one block a tile.

The background is blended outside the kernels, as the JAX function blends
it, so its gradient reaches T through autograd. The layout inside differs
from the TPU's [tiles, features, capacity] blocks: rows are slot-major and
each tile walks only its ``count`` valid slots, not all ``capacity``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.rasterize_jax import gather_tile_gaussians
from tdgs_torch.ops.rasterize_packed import (
    BLOCKS_A_TILE,
    _check,
    _device_kind,
    _launch,
    _plain_walk,
    _response_3dgs,
    backward_walk,
    composite_walk,
    split_count,
)
from tdgs_torch.ops.segment_sum import gather_rows_segsum

KERNEL_FWD = "rasterize_dense_fwd"  # kernel 9
KERNEL_BWD = "rasterize_dense_bwd"  # kernel 10
CHUNK = 128
MAX_CHANNELS = 32
GEOM_COLS = 6  # mx, my, a, b, c, opacity
MAX_RANGES = 8  # kernel 10: the most blocks a tile's slots are cut into


def dense_rows(means2d, conics, colors, opacities, isect_offsets, flatten_ids, n_isects,
               tile_capacity):
    """The per-tile gather: (rows [T, capacity, 6 + D], counts [T] int32)
    from per-gaussian features [I, N, ...] and the dense tiling. Slots at or
    past a tile's count hold some gaussian's row and send no gradient."""
    I, N, D = colors.shape
    gauss_ids, valid = gather_tile_gaussians(isect_offsets, flatten_ids, n_isects,
                                             tile_capacity)
    feats = torch.cat([means2d.reshape(I * N, 2), conics.reshape(I * N, 3),
                       opacities.reshape(I * N, 1), colors.reshape(I * N, D)], dim=-1)
    rows = gather_rows_segsum(feats, gauss_ids.reshape(-1), mask=valid.reshape(-1))
    counts = valid.sum(dim=1, dtype=torch.int32)  # the valid slots lead each tile
    return rows.reshape(gauss_ids.shape + (6 + D,)), counts


def _dense_walk(rows, counts, n_images, image_width, image_height, tile_size, budget):
    """The plain walk over the dense rows: tile t owns slots t·cap ..
    t·cap + count_t of the flattened rows."""
    T, cap, F = rows.shape
    flat = rows.reshape(T * cap, F)
    starts = torch.arange(T, device=rows.device) * cap
    return flat, _plain_walk(
        n_images, image_width, image_height, tile_size, None, None, cap, budget,
        _response_3dgs(flat[:, 0:2], flat[:, 2:5], flat[:, 5]), ranges=(starts, counts))


def rasterize_dense_fwd_plain(rows, counts, n_images, image_width, image_height,
                              tile_size, budget=1 << 24):
    """The plain version of kernel 9: (colors [I, H, W, D] without
    background, T [I, H, W]) from rows [T, cap, 6 + D] and counts [T]."""
    flat, walk = _dense_walk(rows, counts, n_images, image_width, image_height,
                             tile_size, budget)
    img, trans, _ = composite_walk(walk, flat[:, GEOM_COLS:], n_images, image_width,
                                   image_height, tile_size)
    return img, trans


def dense_evaluations(rows, counts, n_images, image_width, image_height,
                      tile_size) -> Tuple[int, int]:
    """(pixel, slot) evaluations a front-to-back walk with per-pixel early
    exit makes on these inputs, and the live ones among them
    (``walked_evaluations``): the work counts behind the kernels' bounds."""
    flat, walk = _dense_walk(rows, counts, n_images, image_width, image_height,
                             tile_size, 1 << 24)
    walked, live = composite_walk(walk, flat[:, GEOM_COLS:], n_images, image_width,
                                  image_height, tile_size)[2].tolist()
    return walked, live


def rasterize_dense_bwd_plain(rows, counts, n_images, image_width, image_height,
                              tile_size, out_colors, out_T, v_colors, v_T,
                              budget=1 << 22):
    """The plain version of kernel 10: gradient rows [T, cap, 6 + D],
    ``[d mx, d my, d a, d b, d c, d op, d colors]`` summed over each tile's
    pixels, zero past the count or the cutoff. ``out_colors``/``out_T`` are
    the forward's outputs, ``v_colors``/``v_T`` their cotangents."""
    flat, walk = _dense_walk(rows, counts, n_images, image_width, image_height,
                             tile_size, budget)
    v_rows = torch.zeros_like(flat)
    backward_walk(walk, flat[:, GEOM_COLS:], n_images, image_width, image_height,
                  tile_size, out_colors, out_T, v_colors, v_T, v_rows)
    return v_rows.reshape(rows.shape)


def _check_rows(rows, counts, n_images, image_width, image_height, tile_size):
    """Checks the kernels' common inputs; returns (T, cap, D)."""
    device = rows.device
    if rows.dim() != 3:
        raise ValueError(f"rows: expected [T, cap, 6 + D], got {tuple(rows.shape)}")
    T, cap, F = rows.shape
    D = F - GEOM_COLS
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    if T != n_images * tw * th:
        raise ValueError(f"rows: {T} tiles for {n_images} images of {tw}x{th} tiles")
    _check("rows", rows, torch.float32, device)
    _check("counts", counts, torch.int32, device, (T,))
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"rows: 1..{MAX_CHANNELS} channels supported, got {D}")
    if not 1 <= tile_size * tile_size <= 1024 or (tile_size * tile_size) % 32:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel, whole "
                         "warps, at most 1024")
    return T, cap, D


def rasterize_dense_fwd(rows, counts, n_images, image_width, image_height, tile_size):
    """Forward → (colors [I, H, W, D] without background, T [I, H, W]).
    CUDA tensors launch kernel 9 (or raise); CPU tensors take the plain
    version."""
    if _device_kind(rows) == "cpu":
        return rasterize_dense_fwd_plain(rows, counts, n_images, image_width,
                                         image_height, tile_size)
    return _launch_dense_fwd(rows, counts, n_images, image_width, image_height, tile_size)


def _launch_dense_fwd(rows, counts, n_images, image_width, image_height, tile_size,
                      n_split=None):
    """Kernel 9 on CUDA tensors, its tiles' warps in ``n_split`` blocks each
    (default ``split_count``; the output does not depend on it)."""
    T, cap, D = _check_rows(rows, counts, n_images, image_width, image_height, tile_size)
    warps = tile_size * tile_size // 32
    if n_split is None:
        n_split = split_count(T, rows.device, warps)
    if n_split < 1 or warps % n_split:
        raise ValueError(f"n_split {n_split}: must divide the {warps} warps of a tile")
    out_c = torch.empty((n_images, image_height, image_width, D), dtype=torch.float32,
                        device=rows.device)
    out_t = torch.empty((n_images, image_height, image_width), dtype=torch.float32,
                        device=rows.device)
    _launch(_build.entry(KERNEL_FWD, 4, 7), KERNEL_FWD, rows, counts, out_c, out_t, n_images,
            image_width, image_height, tile_size, D, cap, n_split)
    BLOCKS_A_TILE[KERNEL_FWD] = n_split
    return out_c, out_t


def rasterize_dense_bwd(rows, counts, n_images, image_width, image_height, tile_size,
                        out_colors, out_T, v_colors, v_T):
    """Gradient rows [T, cap, 6 + D] (see the plain version). CUDA tensors
    launch kernel 10 (or raise); CPU tensors take the plain version."""
    if _device_kind(rows) == "cpu":
        return rasterize_dense_bwd_plain(rows, counts, n_images, image_width,
                                         image_height, tile_size, out_colors, out_T,
                                         v_colors, v_T)
    return _launch_dense_bwd(rows, counts, n_images, image_width, image_height, tile_size,
                             out_colors, out_T, v_colors, v_T)


def _launch_dense_bwd(rows, counts, n_images, image_width, image_height, tile_size,
                      out_colors, out_T, v_colors, v_T, n_split=None):
    """Kernel 10 on CUDA tensors, each tile's slots in ``n_split`` ranges of
    one block each (default ``split_count``; the rows do not depend on it)."""
    T, cap, D = _check_rows(rows, counts, n_images, image_width, image_height, tile_size)
    H, W = image_height, image_width
    for name, t, shape in (("out_colors", out_colors, (n_images, H, W, D)),
                           ("out_T", out_T, (n_images, H, W)),
                           ("v_colors", v_colors, (n_images, H, W, D)),
                           ("v_T", v_T, (n_images, H, W))):
        _check(name, t, torch.float32, rows.device, shape)
    if n_split is None:
        n_split = split_count(T, rows.device, MAX_RANGES)
    if n_split < 1:
        raise ValueError(f"n_split {n_split}: at least one block a tile")
    v_rows = torch.empty_like(rows)
    _launch(_build.entry(KERNEL_BWD, 7, 7), KERNEL_BWD, rows, counts, out_colors, out_T,
            v_colors, v_T, v_rows, n_images, W, H, tile_size, D, cap, n_split)
    BLOCKS_A_TILE[KERNEL_BWD] = n_split
    return v_rows


class _RasterizeDense(torch.autograd.Function):
    """Forward: kernel 9. Backward: kernel 10's gradient rows, which the
    gather's VJP (``gather_rows_segsum``) sums per gaussian."""

    @staticmethod
    def forward(ctx, rows, counts, geometry):
        n_images, width, height, tile_size = geometry
        img, trans = rasterize_dense_fwd(rows, counts, n_images, width, height, tile_size)
        ctx.save_for_backward(rows, counts, img, trans)
        ctx.geometry = geometry
        return img, trans

    @staticmethod
    def backward(ctx, v_img, v_trans):
        rows, counts, img, trans = ctx.saved_tensors
        v_rows = rasterize_dense_bwd(rows, counts, *ctx.geometry, img, trans,
                                     v_img.contiguous(), v_trans.contiguous())
        return v_rows, None, None


def rasterize_to_pixels_pallas(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable tile-dense rasterization (port of
    ``tdgs/ops/rasterize_pallas.py:399``) → (render_colors [..., H, W, D],
    render_alphas [..., H, W, 1]). Gradients reach means2d, conics, colors
    and opacities. ``tile_capacity`` must be a multiple of 128, as the TPU
    kernel's chunks require."""
    if tile_capacity % CHUNK:
        raise ValueError(f"tile_capacity must be a multiple of {CHUNK}, got {tile_capacity}")
    image_dims = tuple(means2d.shape[:-2])
    N = means2d.shape[-2]
    D = colors.shape[-1]
    I = math.prod(image_dims) if image_dims else 1
    tile_height, tile_width = isect_offsets.shape[-2:]
    if (tile_width, tile_height) != (math.ceil(image_width / tile_size),
                                     math.ceil(image_height / tile_size)):
        raise ValueError(f"isect_offsets {tuple(isect_offsets.shape)} for "
                         f"{image_width}x{image_height} in tiles of {tile_size}")
    rows, counts = dense_rows(
        means2d.reshape(I, N, 2), conics.reshape(I, N, 3), colors.reshape(I, N, D),
        opacities.reshape(I, N), isect_offsets.reshape(I, tile_height, tile_width),
        flatten_ids, n_isects, tile_capacity)
    img, trans = _RasterizeDense.apply(rows, counts,
                                       (I, image_width, image_height, tile_size))
    alp = 1.0 - trans
    if backgrounds is not None:
        img = img + (1.0 - alp)[..., None] * backgrounds.reshape(I, 1, 1, D)
    H, W = image_height, image_width
    return img.reshape(image_dims + (H, W, D)), alp.reshape(image_dims + (H, W, 1))
