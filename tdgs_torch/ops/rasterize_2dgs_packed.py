"""Packed-stream 2DGS (surfel) rasterization (port of
``tdgs/ops/rasterize_2dgs_pallas.py``): the forward-only
``rasterize_to_pixels_2dgs_packed_inference`` (:182) and the differentiable
``rasterize_to_pixels_2dgs_packed`` (:335).

The wrapper forms the per-gaussian feature rows
``[mx, my, t0, tpx, tpy, op, channels (D), normals (3)]`` (12 + DA
columns, DA = D + 3), with the cross products t0 = T0×T1, tpx = T1×T2 and
tpy = T2×T0 of the screen-space rows T of K [RS_u, RS_v, mean_c] (the
columns of the projection's ray transform M, ``feature_rows``). The
inference kernel reads them per gaussian through ``flatten_ids``. In
training they are gathered into stream order by
``segment_sum.gather_rows_segsum``, so that the gather's VJP is the
segment-sum kernel and autograd carries the per-entry t0/tpx/tpy gradients
back to M; the tracer's ``surfel_rows`` span holds the rows and their
gather. The per-tile compositing runs in hand-written CUDA kernels for
CUDA tensors (``tdgs_torch/csrc/rasterize_2dgs_fwd.cu``: the inference and
training forwards; ``rasterize_2dgs_bwd.cu``: the gradients) and in the
plain PyTorch versions below for CPU tensors. The walk is the 3DGS one
(``rasterize_packed._plain_walk``: the whole-chunk cut, α clamp 0.999,
1/255 skip, 1e-4 inclusion) with the 2DGS σ = ½·min(σ3d, σ2d).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.rasterize_packed import (
    ALPHA_CLAMP,
    BLOCKS_A_TILE,
    _check,
    _device_kind,
    _launch,
    _plain_walk,
    max_entries_per_tile,
    tile_pixels,
    tile_split,
    untile,
    walked_evaluations,
)
from tdgs_torch.ops.segment_sum import gather_rows_segsum
from tdgs_torch.utils.profiler import span

KERNEL_FWD = "rasterize_2dgs_fwd"  # kernel 4: inference
KERNEL_TRAIN = "rasterize_2dgs_fwd_train"  # kernel 5: the same source, training
KERNEL_BWD = "rasterize_2dgs_bwd"  # kernel 6
GEOM_COLS = 12  # mx, my, t0, tpx, tpy, op
MAX_CHANNELS = 32
TMPZ_EPS = 1e-9
SIGMA_BAD = 1e6


def padded_width(D: int) -> int:
    """The inference kernel's row stride: 12 + D + 3 floats padded to whole
    float4s, so that each row's geometry lands by 16-byte copies."""
    return (GEOM_COLS + D + 3 + 3) // 4 * 4


def feature_rows(means2d, ray_transforms, colors, normals, opacities,
                 width=None) -> torch.Tensor:
    """Per-gaussian rows [I·N, 12 + D + 3]: mx, my, t0, tpx, tpy, op,
    colors, normals; with ``width``, zero columns after them up to that
    width (``padded_width(D)`` for the inference kernel).

    ``ray_transforms`` is the projection's M = (K [RS_u, RS_v, mean_c])ᵀ,
    so the screen-space rows of K [RS_u, RS_v, mean_c], which the ray-splat
    planes h_u = px·T2 − T0 and h_v = py·T2 − T1 are made of, are M's
    columns: t0 = T0×T1, tpx = T1×T2, tpy = T2×T0 are taken over them.
    (The JAX package takes them over M's rows, the transposed matrix; see
    ROADMAP, faults on the reference side.)"""
    I_N = opacities.numel()
    T = ray_transforms.reshape(I_N, 3, 3).transpose(1, 2)  # rows T0, T1, T2
    t0 = torch.linalg.cross(T[:, 0], T[:, 1], dim=-1)
    tpx = torch.linalg.cross(T[:, 1], T[:, 2], dim=-1)
    tpy = torch.linalg.cross(T[:, 2], T[:, 0], dim=-1)
    cols = [means2d.reshape(I_N, 2), t0, tpx, tpy, opacities.reshape(I_N, 1),
            colors.reshape(I_N, -1), normals.reshape(I_N, 3)]
    pad = 0 if width is None else width - GEOM_COLS - colors.shape[-1] - 3
    if pad:
        cols.append(t0.new_zeros((I_N, pad)))
    return torch.cat(cols, dim=-1).contiguous()


def _response_2dgs(rows):
    """σ = ½·min(σ3d, σ2d) of the ray-splat intersection, from the rows of
    the walk's ``ids`` (stream positions, or gaussians through
    ``flatten_ids``); the order of operations is the kernels'
    (rasterize_2dgs_common.cuh). geom is (tmpx, tmpy, rtz, σ3d, dx, dy,
    use3d, px, py, row block)."""

    def response(tt, idx, ids, px, py):
        f = rows[ids]  # [n, L, F]

        def col(j):
            return f[..., j][:, None, :]  # [n, 1, L]

        pxe, pye = px[:, :, None], py[:, :, None]  # [n, P, 1]
        tmpx, tmpy, tmpz = (col(2 + i) + col(5 + i) * pxe + col(8 + i) * pye
                            for i in range(3))
        bad = tmpz.abs() < TMPZ_EPS
        rtz = 1.0 / torch.where(bad, torch.ones_like(tmpz), tmpz)
        sigma3d = torch.where(bad, torch.full_like(tmpz, SIGMA_BAD),
                              (tmpx * tmpx + tmpy * tmpy) * (rtz * rtz))
        dx = col(0) - pxe
        dy = col(1) - pye
        sigma2d = 2.0 * (dx * dx + dy * dy)
        use3d = (sigma3d <= sigma2d) & ~bad
        sigma = 0.5 * torch.minimum(sigma3d, sigma2d)
        return sigma, col(11), (tmpx, tmpy, rtz, sigma3d, dx, dy, use3d, pxe, pye, f)

    return response


def _exclusive_cumsum(x):
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def rasterize_2dgs_fwd_plain(
    rows, offsets, n_images, D, image_width, image_height, tile_size,
    tile_capacity=1024, depth_row=-1, compute_distort=False, budget=1 << 23,
    flatten_ids=None,
):
    """The plain version of kernels 4 and 5 on stream-order ``rows``
    [L, 12 + D + 3], or with ``flatten_ids`` on per-gaussian rows read
    through them. Returns (colors [I, H, W, D] without background, normals
    [I, H, W, 3], T [I, H, W], distortion [I, H, W], median depth
    [I, H, W], ``walked_evaluations`` summed over the tiles)."""
    I = n_images
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    device = rows.device
    P = tile_size * tile_size
    T_total = I * tw * th
    DA = D + 3
    acc = torch.zeros((T_total, P, DA), dtype=torch.float32, device=device)
    out_T = torch.ones((T_total, P, 1), dtype=torch.float32, device=device)
    dist = torch.zeros((T_total, P, 1), dtype=torch.float32, device=device)
    med = torch.zeros((T_total, P, 1), dtype=torch.float32, device=device)
    n_evals = torch.zeros(2, dtype=torch.int64, device=device)
    for c in _plain_walk(I, image_width, image_height, tile_size, offsets, flatten_ids,
                         tile_capacity, budget, _response_2dgs(rows)):
        alpha, included = c.alpha, c.included
        ch = c.geom[-1][..., GEOM_COLS:]  # [n, L, DA]
        w = torch.where(included, alpha * c.T_prev, torch.zeros_like(alpha))
        acc[c.tt] = torch.bmm(w, ch)
        out_T[c.tt, :, 0] = torch.where(included, 1.0 - alpha,
                                        torch.ones_like(alpha)).prod(-1)
        if depth_row >= 0:
            d = ch[..., depth_row][:, None, :]  # [n, 1, L]
            if compute_distort:
                wd = w * d
                A, B = _exclusive_cumsum(w), _exclusive_cumsum(wd)
                dist[c.tt, :, 0] = (2.0 * w * (d * A - B)).sum(-1)
            # the median: the last entry with T_prev > 0.5 and w > 0
            lane = torch.arange(w.shape[-1], device=device)
            last = torch.where((c.T_prev > 0.5) & (w > 0.0), lane, -1).amax(-1)  # [n, P]
            picked = torch.gather(d.expand_as(w), -1, last.clamp(min=0)[..., None])[..., 0]
            med[c.tt, :, 0] = torch.where(last >= 0, picked, torch.zeros_like(picked))
        n_evals += walked_evaluations(c, image_width, image_height)

    args = (I, tw, th, tile_size, image_height, image_width)
    img = untile(acc, *args)
    return (img[..., :D], img[..., D:], untile(out_T, *args)[..., 0],
            untile(dist, *args)[..., 0], untile(med, *args)[..., 0], n_evals)


def rasterize_2dgs_bwd_plain(
    rows, offsets, n_images, D, image_width, image_height, tile_size,
    out_colors, out_normals, out_T, out_dist, v_colors, v_normals, v_T, v_dist,
    tile_capacity=1024, depth_row=-1, compute_distort=False, budget=1 << 21,
) -> torch.Tensor:
    """The plain version of kernel 6: per-entry gradient rows [L, 12 + DA]
    in stream order, ``[d mx, d my, d t0, d tpx, d tpy, d op, d channels]``
    summed over each entry's tile, zero for entries past the cut, past the
    cutoff or past offsets[-1]. ``out_*`` are the training forward's
    outputs, ``v_*`` their cotangents."""
    I = n_images
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    DA = D + 3
    with_dist = compute_distort and depth_row >= 0
    H, W = image_height, image_width

    # per-pixel inputs, tile-major; pixels outside the image contribute 0
    vch = torch.cat([v_colors, v_normals], -1).reshape(I, H, W, DA)
    acc = torch.cat([out_colors, out_normals], -1).reshape(I, H, W, DA)
    totq = (vch * acc).sum(-1, keepdim=True)
    va = (-v_T * out_T).reshape(I, H, W, 1)
    vd = torch.zeros_like(va)
    btot = torch.zeros_like(va)
    atot = torch.zeros_like(va)
    if with_dist:
        vd = v_dist.reshape(I, H, W, 1)
        totq = totq + 2.0 * vd * out_dist.reshape(I, H, W, 1)
        btot = acc[..., depth_row:depth_row + 1]
        atot = 1.0 - out_T.reshape(I, H, W, 1)
    vch_t, totq_t, va_t, vd_t, btot_t, atot_t = (
        tile_pixels(x, I, tw, th, tile_size) for x in (vch, totq, va, vd, btot, atot))

    v_rows = torch.zeros((rows.shape[0], GEOM_COLS + DA), dtype=torch.float32,
                         device=rows.device)
    for c in _plain_walk(I, image_width, image_height, tile_size, offsets, None,
                         tile_capacity, budget, _response_2dgs(rows)):
        tt, valid, idx = c.tt, c.valid, c.idx
        tmpx, tmpy, rtz, sigma3d, dx, dy, use3d, pxe, pye, f = c.geom
        vis, op_vis, alpha, T_prev = c.vis, c.op_vis, c.alpha, c.T_prev
        live = c.included & ~c.skip
        zero = torch.zeros_like(alpha)
        w = torch.where(live, alpha * T_prev, zero)
        ch = f[..., GEOM_COLS:]  # [n, L, DA]

        vcp, tq, vap, vdp = vch_t[tt], totq_t[tt], va_t[tt], vd_t[tt]  # [n, P, DA|1]
        r = torch.bmm(vcp, ch.transpose(1, 2))  # [n, P, L]
        g_depth = None
        if with_dist:
            d = ch[..., depth_row][:, None, :]
            wd = w * d
            Ax, Bx = _exclusive_cumsum(w), _exclusive_cumsum(wd)
            bt, at = btot_t[tt], atot_t[tt]
            r_dist = 2.0 * (d * Ax - Bx) + 2.0 * ((bt - Bx - wd) - d * (at - Ax - w))
            r = r + vdp * r_dist
            g_depth = vdp * (2.0 * w * (2.0 * Ax + w - at))
        suffix = tq - torch.cumsum(w * r, dim=-1)
        ra = 1.0 / (1.0 - alpha)
        v_alpha = torch.where(live, r * T_prev - suffix * ra + vap * ra, zero)
        unclamped = op_vis <= ALPHA_CLAMP
        v_sigma = torch.where(unclamped, -op_vis * v_alpha, zero)
        v_op = torch.where(unclamped, vis * v_alpha, zero)
        v_s3 = torch.where(use3d, v_sigma, zero)
        v_s2 = torch.where(use3d, zero, v_sigma)
        rtz2 = rtz * rtz
        v_tmp = (v_s3 * tmpx * rtz2, v_s3 * tmpy * rtz2, -v_s3 * sigma3d * rtz)
        g_ch = torch.bmm(w.transpose(1, 2), vcp)  # [n, L, DA]
        if g_depth is not None:
            g_ch[..., depth_row] += g_depth.sum(1)
        out = torch.cat([
            torch.stack([(2.0 * v_s2 * dx).sum(1), (2.0 * v_s2 * dy).sum(1)]
                        + [v.sum(1) for v in v_tmp]
                        + [(v * pxe).sum(1) for v in v_tmp]
                        + [(v * pye).sum(1) for v in v_tmp]
                        + [v_op.sum(1)], dim=-1),
            g_ch,
        ], dim=-1)  # [n, L, 12 + DA]
        v_rows[idx[valid]] = out[valid]
    return v_rows


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _load(symbol, n_ptrs, n_ints, slots=False):
    fn = getattr(_build.load(KERNEL_BWD if symbol.endswith("bwd") else KERNEL_FWD),
                 f"tdgs_{symbol}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + ([ctypes.c_int64] if slots else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_rows(rows, offsets, n_images, D, image_width, image_height, tile_size,
                width=None):
    device = rows.device
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"colors: 1..{MAX_CHANNELS} channels supported, got {D}")
    _check("rows", rows, torch.float32, device,
           (rows.shape[0], width or GEOM_COLS + D + 3))
    _check("offsets", offsets, torch.int32, device, (n_images * tw * th + 1,))
    if not 1 <= tile_size * tile_size <= 1024 or (tile_size * tile_size) % 32:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel, whole "
                         "warps, at most 1024")
    return tw, th


def rasterize_2dgs_inference(feats, flatten_ids, offsets, n_images, D, image_width,
                             image_height, tile_size, backgrounds=None, tile_capacity=1024,
                             n_split=None):
    """Kernel 4 → (colors [I, H, W, D] with the background blended, alphas
    [I, H, W, 1], normals [I, H, W, 3]) from per-gaussian rows ``feats``
    [G, padded_width(D)] (``feature_rows(..., width=padded_width(D))``)
    read through ``flatten_ids`` [L] int32. CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version. Both take the same
    inputs."""
    H, W = image_height, image_width
    tw, th = _check_rows(feats, offsets, n_images, D, W, H, tile_size, padded_width(D))
    _check("flatten_ids", flatten_ids, torch.int32, feats.device, (flatten_ids.shape[0],))
    if backgrounds is not None:
        _check("backgrounds", backgrounds, torch.float32, feats.device, (n_images, D))
    n_split = tile_split(tile_size, n_split)
    if _device_kind(feats) == "cpu":
        img, nrm, T, _, _, _ = rasterize_2dgs_fwd_plain(
            feats[:, :GEOM_COLS + D + 3], offsets, n_images, D, W, H, tile_size,
            tile_capacity, flatten_ids=flatten_ids)
        alp = 1.0 - T
        if backgrounds is not None:
            img = img + (1.0 - alp)[..., None] * backgrounds.reshape(n_images, 1, 1, D)
        return img, alp[..., None], nrm
    out_c = feats.new_empty((n_images, H, W, D))
    out_n = feats.new_empty((n_images, H, W, 3))
    out_a = feats.new_empty((n_images, H, W, 1))
    _launch(_load("rasterize_2dgs_fwd", 7, 10), KERNEL_FWD, feats, flatten_ids, offsets,
            None if backgrounds is None else backgrounds.data_ptr(), out_c, out_n, out_a,
            n_images, W, H, tile_size, tw, th, D, max_entries_per_tile(tile_capacity),
            feats.shape[1], n_split)
    BLOCKS_A_TILE[KERNEL_FWD] = n_split
    return out_c, out_a, out_n


def rasterize_2dgs_train_fwd(rows, offsets, n_images, D, image_width, image_height,
                             tile_size, tile_capacity=1024, depth_row=-1,
                             compute_distort=False, n_split=None):
    """Kernel 5 on stream-order ``rows`` [L, 12 + D + 3] → (colors
    [I, H, W, D] without background, normals [I, H, W, 3], T, distortion,
    median depth [I, H, W]). CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    H, W = image_height, image_width
    if _device_kind(rows) == "cpu":
        return rasterize_2dgs_fwd_plain(rows, offsets, n_images, D, W, H, tile_size,
                                        tile_capacity, depth_row, compute_distort)[:5]
    tw, th = _check_rows(rows, offsets, n_images, D, W, H, tile_size)
    if depth_row >= D:
        raise ValueError(f"depth_row {depth_row} outside {D} channels")
    n_split = tile_split(tile_size, n_split)
    out_c = rows.new_empty((n_images, H, W, D))
    out_n = rows.new_empty((n_images, H, W, 3))
    out_t, out_d, out_m = (rows.new_empty((n_images, H, W)) for _ in range(3))
    _launch(_load("rasterize_2dgs_fwd_train", 7, 11), KERNEL_TRAIN, rows, offsets,
            out_c, out_n, out_t, out_d, out_m, n_images, W, H, tile_size, tw, th, D,
            max_entries_per_tile(tile_capacity), depth_row, int(compute_distort), n_split)
    BLOCKS_A_TILE[KERNEL_TRAIN] = n_split
    return out_c, out_n, out_t, out_d, out_m


def rasterize_2dgs_bwd(rows, offsets, n_images, D, image_width, image_height,
                       tile_size, out_colors, out_normals, out_T, out_dist,
                       v_colors, v_normals, v_T, v_dist, tile_capacity=1024,
                       depth_row=-1, compute_distort=False):
    """Kernel 6: per-entry gradient rows [L, 12 + DA] (see the plain
    version). CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    H, W = image_height, image_width
    per_pixel = (out_colors, out_normals, out_T, out_dist, v_colors, v_normals, v_T, v_dist)
    if _device_kind(rows) == "cpu":
        return rasterize_2dgs_bwd_plain(rows, offsets, n_images, D, W, H, tile_size,
                                        *per_pixel, tile_capacity, depth_row,
                                        compute_distort)
    tw, th = _check_rows(rows, offsets, n_images, D, W, H, tile_size)
    if depth_row >= D:
        raise ValueError(f"depth_row {depth_row} outside {D} channels")
    shapes = ((D,), (3,), (), ()) * 2
    names = ("out_colors", "out_normals", "out_T", "out_dist",
             "v_colors", "v_normals", "v_T", "v_dist")
    for name, t, tail in zip(names, per_pixel, shapes):
        _check(name, t, torch.float32, rows.device, (n_images, H, W) + tail)
    L = rows.shape[0]
    v_rows = rows.new_empty((L, rows.shape[1]))
    fn = _load("rasterize_2dgs_bwd", 11, 10, slots=True)
    _launch(fn, KERNEL_BWD, rows, offsets, *per_pixel, v_rows, n_images, W, H,
            tile_size, tw, th, D, max_entries_per_tile(tile_capacity), depth_row,
            int(compute_distort), L)
    return v_rows


class _Rasterize2DGS(torch.autograd.Function):
    """Forward: kernel 5 on the gathered rows. Backward: kernel 6's
    per-entry rows, which ``gather_rows_segsum``'s VJP (the segment-sum
    kernel) sums per gaussian. Median depth is not differentiable."""

    @staticmethod
    def forward(ctx, rows, offsets, geometry):
        I, D, width, height, tile_size, tile_capacity, depth_row, distort = geometry
        outs = rasterize_2dgs_train_fwd(rows, offsets, I, D, width, height, tile_size,
                                        tile_capacity, depth_row, distort)
        ctx.mark_non_differentiable(outs[4])
        ctx.save_for_backward(rows, offsets, *outs[:4])
        ctx.geometry = geometry
        return outs

    @staticmethod
    def backward(ctx, v_colors, v_normals, v_T, v_dist, _v_median):
        rows, offsets, colors, normals, T, dist = ctx.saved_tensors
        I, D, width, height, tile_size, tile_capacity, depth_row, distort = ctx.geometry
        v_rows = rasterize_2dgs_bwd(
            rows, offsets, I, D, width, height, tile_size, colors, normals, T, dist,
            v_colors.contiguous(), v_normals.contiguous(), v_T.contiguous(),
            v_dist.contiguous(), tile_capacity, depth_row, distort)
        return v_rows, None, None


def _image_count(means2d):
    image_dims = tuple(means2d.shape[:-2])
    return image_dims, (math.prod(image_dims) if image_dims else 1)


def rasterize_to_pixels_2dgs_packed_inference(
    means2d: torch.Tensor,  # [..., N, 2]
    ray_transforms: torch.Tensor,  # [..., N, 3, 3]
    colors: torch.Tensor,  # [..., N, D]
    normals: torch.Tensor,  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T+1] int32 (isect_tiles_packed)
    flatten_ids: torch.Tensor,  # [L] int32
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-only packed 2DGS rasterization → (colors [..., H, W, D],
    alphas [..., H, W, 1], camera-frame normals [..., H, W, 3]); kernel 4
    on CUDA tensors, its plain version on CPU tensors. Not differentiable."""
    image_dims, I = _image_count(means2d)
    D = colors.shape[-1]
    with torch.no_grad():
        feats = feature_rows(means2d, ray_transforms, colors, normals, opacities,
                             width=padded_width(D))
        img, alp, nrm = rasterize_2dgs_inference(
            feats, flatten_ids, offsets, I, D, image_width, image_height, tile_size,
            None if backgrounds is None else backgrounds.reshape(I, D).contiguous(),
            tile_capacity)
    shp = image_dims + (image_height, image_width)
    return img.reshape(shp + (D,)), alp.reshape(shp + (1,)), nrm.reshape(shp + (3,))


def rasterize_to_pixels_2dgs_packed(
    means2d: torch.Tensor,  # [..., N, 2]
    ray_transforms: torch.Tensor,  # [..., N, 3, 3]
    colors: torch.Tensor,  # [..., N, D] (last channel depth when present)
    normals: torch.Tensor,  # [..., N, 3]
    opacities: torch.Tensor,  # [..., N]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T+1] int32
    flatten_ids: torch.Tensor,  # [L] int32
    backgrounds: Optional[torch.Tensor] = None,  # [..., D]
    tile_capacity: int = 1024,
    has_depth: bool = False,
    compute_distort: bool = False,
    absgrad_dummy: Optional[torch.Tensor] = None,  # [I*N, 2] zeros
) -> Tuple[torch.Tensor, ...]:
    """Differentiable packed 2DGS rasterization → (colors [..., H, W, D],
    alphas [..., H, W, 1], camera-frame normals [..., H, W, 3], distortion
    [..., H, W, 1], median depth [..., H, W, 1]).

    Gradients reach means2d, ray_transforms, colors, normals and
    opacities; median depth is not differentiable. Distortion and median
    need ``has_depth`` (the last colour channel is depth); distortion also
    ``compute_distort``. The background is blended here, outside the
    kernel, so autograd sees it. ``absgrad_dummy``: zeros whose gradient is
    the per-gaussian sum of |per-entry screen-space gradients| (AbsGS)."""
    image_dims, I = _image_count(means2d)
    D = colors.shape[-1]
    with span("surfel_rows"):
        feats = feature_rows(means2d, ray_transforms, colors, normals, opacities)
        rows = gather_rows_segsum(feats, flatten_ids, offsets[-1], absgrad_dummy)
    depth_row = D - 1 if has_depth else -1
    colors_img, normals_img, trans, dist, med = _Rasterize2DGS.apply(
        rows, offsets,
        (I, D, image_width, image_height, tile_size, tile_capacity, depth_row,
         bool(compute_distort and has_depth)))
    alp = 1.0 - trans
    if backgrounds is not None:
        colors_img = colors_img + (1.0 - alp)[..., None] * backgrounds.reshape(I, 1, 1, D)
    shp = image_dims + (image_height, image_width)
    return (colors_img.reshape(shp + (D,)), alp.reshape(shp + (1,)),
            normals_img.reshape(shp + (3,)), dist.reshape(shp + (1,)),
            med.reshape(shp + (1,)))
