"""Packed-stream world-space (eval3d, 3DGUT) rasterization (port of
``tdgs/ops/rasterize_eval3d_pallas.py``: ``rasterize_to_pixels_eval3d_packed``
:328 with its custom VJP :815-949).

Each pixel evaluates the largest response of a gaussian along its true
camera ray (distortion and rolling shutter included, ``camera_models``),
not the EWA screen-space conic. ``tile_rays_world`` gives every tile
pixel its world ray o_ref + o' + t·d, recentred on the start-pose camera
centre o_ref (o' = 0 for a central camera with a global shutter). The
per-gaussian feature rows are ``[M (9), g0 (3), opacity, colours (D)]``
with M = diag(1/s)·Rᵀ and g0 = M(o_ref − μ) (``feature_rows``); in the
canonical frame r = M·d, g = g0 + M·o' and

    σ* = min_t ½|g + t·r|² = ½|g × r|² / |r|²,  kept only where g·r < 0.

The cross product takes σ* without the cancellation of the JAX package's
expanded quadratic form ½(|g|² − (g·r)²/|r|²), whose two terms are of size
(distance/scale)² (ROADMAP, faults on the reference side).

The rows are gathered into stream order by ``segment_sum.gather_rows_segsum``
(its VJP is the segment-sum kernel). The per-tile compositing runs in
hand-written CUDA kernels for CUDA tensors (``csrc/rasterize_eval3d_fwd.cu``,
kernel 7: render, eval and the training forward;
``csrc/rasterize_eval3d_bwd.cu``, kernel 8: gradients of the rows and of
the rays) and in the plain PyTorch versions below for CPU tensors; both
walk the stream as ``rasterize_packed._plain_walk`` does (the whole-chunk
cut, α clamp 0.999, 1/255 skip, 1e-4 inclusion). Autograd carries the row
gradients to means, quats, scales, opacities and colours, and the ray
gradients to ``viewmats`` and ``viewmats_rs``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tdgs_torch.ops import _build
from tdgs_torch.ops.camera_models import (
    FThetaCameraDistortionParameters,
    RollingShutterType,
    shutter_time_from_pixel,
    unproject_pixel,
)
from tdgs_torch.ops.rasterize_packed import (
    ALPHA_CLAMP,
    _check,
    _device_kind,
    _launch,
    _plain_walk,
    max_entries_per_tile,
    tile_pixels,
    untile,
    walked_evaluations,
)
from tdgs_torch.ops.segment_sum import gather_rows_segsum
from tdgs_torch.ops.transforms import (
    quat_normalize,
    quat_rotate,
    quat_to_rotmat,
    rotmat_to_quat,
)
from tdgs_torch.utils.profiler import span

KERNEL_FWD = "rasterize_eval3d_fwd"  # kernel 7, its forward-only call
KERNEL_TRAIN = "rasterize_eval3d_fwd_train"  # kernel 7's training call (same source)
KERNEL_BWD = "rasterize_eval3d_bwd"  # kernel 8
GEOM_COLS = 13  # M (9), g0 (3), opacity
MAX_CHANNELS = 32
RR_MIN = 1e-12


def tile_rays_world(
    n_images: int,
    tile_width: int,
    tile_height: int,
    tile_size: int,
    image_width: int,
    image_height: int,
    viewmats: torch.Tensor,  # [I, 4, 4]
    Ks: torch.Tensor,  # [I, 3, 3]
    camera_model: str = "pinhole",
    radial_coeffs: Optional[torch.Tensor] = None,  # [I, k]
    tangential_coeffs: Optional[torch.Tensor] = None,
    thin_prism_coeffs: Optional[torch.Tensor] = None,
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[torch.Tensor] = None,  # [I, 4, 4] frame end
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """World rays of every tile pixel (port of ``_tile_rays_world`` :249):
    (d [T, P, 3] unit directions, o' [T, P, 3] origins recentred on o_ref,
    or None for a central camera, o_ref [I, 3] = −Rᵀt of the start pose).
    Tile-major, T = I·tile_height·tile_width, P = tile_size²."""
    device = viewmats.device
    tiles_per_image = tile_width * tile_height
    R_wc = viewmats[:, :3, :3]
    t_wc = viewmats[:, :3, 3]
    o_ref = -(R_wc.transpose(1, 2) @ t_wc[..., None])[..., 0]  # [I, 3]

    tile_ids = torch.arange(n_images * tiles_per_image, device=device)
    t_in = tile_ids % tiles_per_image
    img_of_tile = tile_ids // tiles_per_image
    p = torch.arange(tile_size * tile_size, device=device)
    px = ((t_in % tile_width) * tile_size)[:, None] + (p % tile_size)[None, :]
    py = ((t_in // tile_width) * tile_size)[:, None] + (p // tile_size)[None, :]
    pixels = torch.stack([px, py], dim=-1).to(torch.float32) + 0.5  # [T, P, 2]

    def per_tile(arr):
        return None if arr is None else arr[img_of_tile][:, None]

    d_cam = unproject_pixel(pixels, Ks[img_of_tile][:, None], camera_model,
                            per_tile(radial_coeffs), per_tile(tangential_coeffs),
                            per_tile(thin_prism_coeffs), ftheta_coeffs)  # [T, P, 3]
    if viewmats_rs is None or rolling_shutter == RollingShutterType.GLOBAL:
        # a central camera with a global shutter: o' ≡ 0 (distortion bends
        # the rays, it never moves their origin); d_world = Rᵀ d_cam
        d = (d_cam[..., None, :] * R_wc.transpose(1, 2)[img_of_tile][:, None]).sum(-1)
        return d, None, o_ref
    # each pixel rides the pose interpolated at its shutter time
    t_sh = shutter_time_from_pixel(pixels, image_width, image_height, rolling_shutter)
    q0 = rotmat_to_quat(R_wc)
    q1 = rotmat_to_quat(viewmats_rs[:, :3, :3])
    sign = torch.where((q0 * q1).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    ts = t_sh[..., None]
    q = quat_normalize(q0[img_of_tile][:, None] * (1.0 - ts)
                       + (q1 * sign)[img_of_tile][:, None] * ts)  # [T, P, 4]
    trans = (t_wc[img_of_tile][:, None] * (1.0 - ts)
             + viewmats_rs[:, :3, 3][img_of_tile][:, None] * ts)
    q_inv = q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=device)
    o_pix = -quat_rotate(q_inv, trans)
    d = quat_rotate(q_inv, d_cam)
    return d, o_pix - o_ref[img_of_tile][:, None], o_ref


def feature_rows(means, quats, scales, opacities, colors, o_ref) -> torch.Tensor:
    """Per-gaussian rows [I·N, 13 + D]: M = diag(1/s)·Rᵀ (9, row-major),
    g0 = M(o_ref − μ) (3), opacity, colours. ``means``/``quats``/``scales``
    [N, ·], ``opacities`` [I, N], ``colors`` [I, N, D], ``o_ref`` [I, 3]."""
    I, N = opacities.shape
    R = quat_to_rotmat(quats)  # [N, 3, 3]
    M = R.transpose(1, 2) / torch.clamp(scales, min=1e-8)[:, :, None]  # row i: R[:, i] / s_i
    m = o_ref[:, None, :] - means[None]  # [I, N, 3]
    g0 = (M[None] * m[:, :, None, :]).sum(-1)  # [I, N, 3]
    return torch.cat([
        M.reshape(1, N, 9).expand(I, N, 9), g0, opacities[..., None], colors,
    ], dim=-1).reshape(I * N, -1).contiguous()


def _response_eval3d(rows, d, o):
    """σ* of the stream-order ``rows`` along the tile rays ``d`` (and ``o``,
    None when central), in the kernels' order of operations
    (rasterize_eval3d_common.cuh). Entries behind the camera (g·r ≥ 0) get
    σ = −1, which the walk skips. geom is (r, g, c, g·r, |r|², row block)."""

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def response(tt, idx, ids, px, py):
        f = rows[idx]  # [n, L, F]
        col = [f[..., j][:, None, :] for j in range(GEOM_COLS)]  # [n, 1, L]
        dt = [d[tt][..., k][:, :, None] for k in range(3)]  # [n, P, 1]
        r = [dot3(col[3 * i:3 * i + 3], dt) for i in range(3)]
        if o is None:
            g = col[9:12]
        else:
            ot = [o[tt][..., k][:, :, None] for k in range(3)]
            g = [col[9 + i] + dot3(col[3 * i:3 * i + 3], ot) for i in range(3)]
        gr = dot3(g, r)
        c = [g[1] * r[2] - g[2] * r[1], g[2] * r[0] - g[0] * r[2], g[0] * r[1] - g[1] * r[0]]
        rr = torch.clamp(dot3(r, r), min=RR_MIN)
        sigma = 0.5 * (dot3(c, c) / rr)
        sigma = torch.where(gr < 0.0, sigma, torch.full_like(sigma, -1.0))
        return sigma, col[12], (r, g, c, gr, rr, f)

    return response


def rasterize_eval3d_fwd_plain(rows, d, o, offsets, n_images, D, image_width,
                               image_height, tile_size, tile_capacity=1024,
                               budget=1 << 22):
    """The plain version of kernel 7 on stream-order ``rows`` [L, 13 + D].
    Returns (colors [I, H, W, D] without background, T [I, H, W],
    ``walked_evaluations`` summed over the tiles)."""
    I = n_images
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    device = rows.device
    P = tile_size * tile_size
    acc = torch.zeros((I * tw * th, P, D), dtype=torch.float32, device=device)
    out_T = torch.ones((I * tw * th, P, 1), dtype=torch.float32, device=device)
    n_evals = torch.zeros(2, dtype=torch.int64, device=device)
    for c in _plain_walk(I, image_width, image_height, tile_size, offsets, None,
                         tile_capacity, budget, _response_eval3d(rows, d, o)):
        w = torch.where(c.included, c.alpha * c.T_prev, torch.zeros_like(c.alpha))
        acc[c.tt] = torch.bmm(w, c.geom[-1][..., GEOM_COLS:])
        out_T[c.tt, :, 0] = torch.where(c.included, 1.0 - c.alpha,
                                        torch.ones_like(c.alpha)).prod(-1)
        n_evals += walked_evaluations(c, image_width, image_height)
    args = (I, tw, th, tile_size, image_height, image_width)
    return untile(acc, *args), untile(out_T, *args)[..., 0], n_evals


def rasterize_eval3d_bwd_plain(rows, d, o, offsets, n_images, D, image_width,
                               image_height, tile_size, out_colors, out_T, v_colors,
                               v_T, tile_capacity=1024, budget=1 << 21):
    """The plain version of kernel 8: (per-entry gradient rows [L, 13 + D]
    in stream order, ``[d M (9), d g0 (3), d op, d colours]`` summed over
    each entry's tile and zero for entries past the cut, past the cutoff or
    past offsets[-1]; v_d [T, P, 3]; v_o' [T, P, 3] or None when central).
    ``out_*`` are the training forward's outputs, ``v_*`` their
    cotangents."""
    I = n_images
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    H, W = image_height, image_width

    # per-pixel inputs, tile-major; pixels outside the image contribute 0
    vcol = v_colors.reshape(I, H, W, D)
    totq = (vcol * out_colors.reshape(I, H, W, D)).sum(-1, keepdim=True)
    va = (-v_T * out_T).reshape(I, H, W, 1)
    vcol_t, totq_t, va_t = (tile_pixels(x, I, tw, th, tile_size) for x in (vcol, totq, va))

    v_rows = torch.zeros((rows.shape[0], GEOM_COLS + D), dtype=torch.float32,
                         device=rows.device)
    v_d = torch.zeros_like(d)
    v_o = None if o is None else torch.zeros_like(o)
    for c in _plain_walk(I, image_width, image_height, tile_size, offsets, None,
                         tile_capacity, budget, _response_eval3d(rows, d, o)):
        tt, valid, idx = c.tt, c.valid, c.idx
        r, g, cr, gr, rr, f = c.geom
        vis, op_vis, alpha, T_prev = c.vis, c.op_vis, c.alpha, c.T_prev
        live = c.included & ~c.skip
        zero = torch.zeros_like(alpha)
        w = torch.where(live, alpha * T_prev, zero)

        vcp, tq, vap = vcol_t[tt], totq_t[tt], va_t[tt]  # [n, P, D|1|1]
        r_ch = torch.bmm(vcp, f[..., GEOM_COLS:].transpose(1, 2))  # [n, P, L]
        suffix = tq - torch.cumsum(w * r_ch, dim=-1)
        ra = 1.0 / (1.0 - alpha)
        v_alpha = torch.where(live, r_ch * T_prev - suffix * ra + vap * ra, zero)
        unclamped = op_vis <= ALPHA_CLAMP
        v_sigma = torch.where(unclamped, -op_vis * v_alpha, zero)
        v_op = torch.where(unclamped, vis * v_alpha, zero)
        kk = v_sigma / rr
        coef = -kk * (gr / rr)
        u = (r[1] * cr[2] - r[2] * cr[1], r[2] * cr[0] - r[0] * cr[2],
             r[0] * cr[1] - r[1] * cr[0])
        v_r = [coef * ui for ui in u]
        v_g = [kk * ui for ui in u]
        dt = [d[tt][..., k][:, :, None] for k in range(3)]  # [n, P, 1]
        ot = None if o is None else [o[tt][..., k][:, :, None] for k in range(3)]
        v_M = []
        for i in range(3):
            for j in range(3):
                term = v_r[i] * dt[j]
                if ot is not None:
                    term = term + v_g[i] * ot[j]
                v_M.append(term.sum(1))
        out = torch.cat([
            torch.stack(v_M + [v.sum(1) for v in v_g] + [v_op.sum(1)], dim=-1),
            torch.bmm(w.transpose(1, 2), vcp),  # [n, L, D]
        ], dim=-1)  # [n, L, 13 + D]
        v_rows[idx[valid]] = out[valid]
        Mcol = [f[..., j][:, None, :] for j in range(9)]  # [n, 1, L]
        for j in range(3):
            v_d[tt, :, j] = sum(Mcol[3 * i + j] * v_r[i] for i in range(3)).sum(-1)
            if v_o is not None:
                v_o[tt, :, j] = sum(Mcol[3 * i + j] * v_g[i] for i in range(3)).sum(-1)
    return v_rows, v_d, v_o


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_inputs(rows, d, o, offsets, n_images, D, image_width, image_height,
                  tile_size):
    device = rows.device
    tw, th = math.ceil(image_width / tile_size), math.ceil(image_height / tile_size)
    if not 1 <= D <= MAX_CHANNELS:
        raise ValueError(f"colors: 1..{MAX_CHANNELS} channels supported, got {D}")
    P = tile_size * tile_size
    if not 1 <= P <= 1024 or P % 32:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel, whole "
                         "warps, at most 1024")
    T = n_images * tw * th
    _check("rows", rows, torch.float32, device, (rows.shape[0], GEOM_COLS + D))
    _check("rays_d", d, torch.float32, device, (T, P, 3))
    if o is not None:
        _check("rays_o", o, torch.float32, device, (T, P, 3))
    _check("offsets", offsets, torch.int32, device, (T + 1,))
    return tw, th


def _launch_fwd(rows, d, o, offsets, n_images, D, W, H, tile_size, backgrounds,
                tile_capacity, write_transmittance):
    tw, th = _check_inputs(rows, d, o, offsets, n_images, D, W, H, tile_size)
    if backgrounds is not None:
        _check("backgrounds", backgrounds, torch.float32, rows.device, (n_images, D))
    out_c = rows.new_empty((n_images, H, W, D))
    out_a = rows.new_empty((n_images, H, W))
    name = KERNEL_TRAIN if write_transmittance else KERNEL_FWD
    _launch(_build.entry(KERNEL_FWD, 7, 9), name, rows, d, o, offsets,
            backgrounds, out_c, out_a, n_images, W, H, tile_size, tw, th, D,
            max_entries_per_tile(tile_capacity), int(write_transmittance))
    return out_c, out_a


def rasterize_eval3d_inference(rows, d, o, offsets, n_images, D, image_width,
                               image_height, tile_size, backgrounds=None,
                               tile_capacity=1024):
    """Kernel 7, forward only → (colors [I, H, W, D] with the background
    blended, alphas [I, H, W, 1]). CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    H, W = image_height, image_width
    if _device_kind(rows) == "cpu":
        img, T, _ = rasterize_eval3d_fwd_plain(rows, d, o, offsets, n_images, D, W, H,
                                               tile_size, tile_capacity)
        alp = (1.0 - T)[..., None]
        if backgrounds is not None:
            img = img + (1.0 - alp) * backgrounds.reshape(n_images, 1, 1, D)
        return img, alp
    img, alp = _launch_fwd(rows, d, o, offsets, n_images, D, W, H, tile_size,
                           backgrounds, tile_capacity, False)
    return img, alp[..., None]


def rasterize_eval3d_train_fwd(rows, d, o, offsets, n_images, D, image_width,
                               image_height, tile_size, tile_capacity=1024):
    """Kernel 7, the training call → (colors [I, H, W, D] without
    background, T [I, H, W]). CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    H, W = image_height, image_width
    if _device_kind(rows) == "cpu":
        return rasterize_eval3d_fwd_plain(rows, d, o, offsets, n_images, D, W, H,
                                          tile_size, tile_capacity)[:2]
    return _launch_fwd(rows, d, o, offsets, n_images, D, W, H, tile_size, None,
                       tile_capacity, True)


def rasterize_eval3d_bwd(rows, d, o, offsets, n_images, D, image_width, image_height,
                         tile_size, out_colors, out_T, v_colors, v_T,
                         tile_capacity=1024):
    """Kernel 8 → (v_rows [L, 13 + D], v_d [T, P, 3], v_o' [T, P, 3] or
    None when central); see the plain version. CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    H, W = image_height, image_width
    per_pixel = (out_colors, out_T, v_colors, v_T)
    if _device_kind(rows) == "cpu":
        return rasterize_eval3d_bwd_plain(rows, d, o, offsets, n_images, D, W, H,
                                          tile_size, *per_pixel, tile_capacity)
    tw, th = _check_inputs(rows, d, o, offsets, n_images, D, W, H, tile_size)
    for name, t, tail in zip(("out_colors", "out_T", "v_colors", "v_T"), per_pixel,
                             ((D,), (), (D,), ())):
        _check(name, t, torch.float32, rows.device, (n_images, H, W) + tail)
    v_rows = rows.new_empty(rows.shape)
    v_d = torch.empty_like(d)
    v_o = None if o is None else torch.empty_like(o)
    _launch(_build.entry(KERNEL_BWD, 11, 8, slots=True), KERNEL_BWD, rows, d, o,
            offsets, *per_pixel, v_rows, v_d, v_o, n_images, W, H, tile_size, tw, th, D,
            max_entries_per_tile(tile_capacity), rows.shape[0])
    return v_rows, v_d, v_o


class _RasterizeEval3D(torch.autograd.Function):
    """Forward: kernel 7 (training call) on the gathered rows. Backward:
    kernel 8's row and ray gradients; ``gather_rows_segsum``'s VJP (the
    segment-sum kernel) sums the rows per gaussian."""

    @staticmethod
    def forward(ctx, rows, d, o, offsets, geometry):
        I, D, width, height, tile_size, tile_capacity = geometry
        img, T = rasterize_eval3d_train_fwd(rows, d, o, offsets, I, D, width, height,
                                            tile_size, tile_capacity)
        ctx.save_for_backward(rows, d, o, offsets, img, T)
        ctx.geometry = geometry
        return img, T

    @staticmethod
    def backward(ctx, v_img, v_T):
        rows, d, o, offsets, img, T = ctx.saved_tensors
        I, D, width, height, tile_size, tile_capacity = ctx.geometry
        v_rows, v_d, v_o = rasterize_eval3d_bwd(
            rows, d, o, offsets, I, D, width, height, tile_size, img, T,
            v_img.contiguous(), v_T.contiguous(), tile_capacity)
        return v_rows, v_d, v_o, None, None


def rasterize_to_pixels_eval3d_packed(
    means: torch.Tensor,  # [N, 3] world space
    quats: torch.Tensor,  # [N, 4] wxyz
    scales: torch.Tensor,  # [N, 3]
    colors: torch.Tensor,  # [I, N, D]
    opacities: torch.Tensor,  # [I, N]
    viewmats: torch.Tensor,  # [I, 4, 4]
    Ks: torch.Tensor,  # [I, 3, 3]
    image_width: int,
    image_height: int,
    tile_size: int,
    offsets: torch.Tensor,  # [T + 1] int32 (isect_tiles_packed)
    flatten_ids: torch.Tensor,  # [L] int32 → indices into I·N
    camera_model: str = "pinhole",
    radial_coeffs: Optional[torch.Tensor] = None,  # [I, k]
    tangential_coeffs: Optional[torch.Tensor] = None,
    thin_prism_coeffs: Optional[torch.Tensor] = None,
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    tile_capacity: int = 1024,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[torch.Tensor] = None,  # [I, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space rasterization of the packed stream → (colors
    [I, H, W, D], alphas [I, H, W, 1]).

    Differentiable: when autograd records, kernel 7's training call and
    kernel 8 run behind ``_RasterizeEval3D`` and the background is blended
    here, outside the kernel, so autograd sees it; otherwise kernel 7's
    forward-only call blends the background itself."""
    I, N = opacities.shape
    D = colors.shape[-1]
    tw = math.ceil(image_width / tile_size)
    th = math.ceil(image_height / tile_size)
    with span("eval3d_rays"):
        d, o, o_ref = tile_rays_world(
            I, tw, th, tile_size, image_width, image_height, viewmats, Ks, camera_model,
            radial_coeffs, tangential_coeffs, thin_prism_coeffs, ftheta_coeffs,
            rolling_shutter, viewmats_rs)
    with span("eval3d_rows"):
        feats = feature_rows(means, quats, scales, opacities, colors, o_ref)
        rows, grads = _stream_rows(feats, d, o, offsets, flatten_ids)
    return _rasterize_rows(rows, grads, d, o, offsets, I, D, image_width, image_height,
                           tile_size, backgrounds, tile_capacity)


def _stream_rows(feats, d, o, offsets, flatten_ids):
    """The feature rows in stream order → (rows, whether autograd records):
    gathered by ``gather_rows_segsum`` (whose VJP is the segment-sum
    kernel) when it does, by indexing otherwise."""
    grads = torch.is_grad_enabled() and (
        feats.requires_grad or d.requires_grad or (o is not None and o.requires_grad))
    if not grads:
        return feats[flatten_ids.long()], False
    return gather_rows_segsum(feats, flatten_ids, offsets[-1]), True


def rasterize_feature_rows(
    feats: torch.Tensor,  # [I·N, 13 + D] (feature_rows)
    d: torch.Tensor,  # [T, P, 3] (tile_rays_world)
    o: Optional[torch.Tensor],  # [T, P, 3] or None
    offsets: torch.Tensor,  # [T + 1] int32
    flatten_ids: torch.Tensor,  # [L] int32 → indices into I·N
    n_images: int,
    D: int,
    image_width: int,
    image_height: int,
    tile_size: int,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    tile_capacity: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The world-space rasterization of per-gaussian feature rows already
    built (``rasterize_to_pixels_eval3d_packed`` after ``feature_rows``;
    the sharded path builds the rows before its exchange) → (colors
    [I, H, W, D], alphas [I, H, W, 1])."""
    with span("eval3d_rows"):
        rows, grads = _stream_rows(feats, d, o, offsets, flatten_ids)
    return _rasterize_rows(rows, grads, d, o, offsets, n_images, D, image_width,
                           image_height, tile_size, backgrounds, tile_capacity)


def _rasterize_rows(rows, grads, d, o, offsets, n_images, D, image_width, image_height,
                    tile_size, backgrounds, tile_capacity):
    """Kernel 7's forward-only call on stream-order ``rows``, or (``grads``)
    its training call and kernel 8 behind autograd, the background blended
    outside them."""
    I = n_images
    d = d.contiguous()
    o = None if o is None else o.contiguous()
    bg = None if backgrounds is None else backgrounds.reshape(I, D).contiguous()
    if not grads:
        return rasterize_eval3d_inference(rows, d, o, offsets, I, D, image_width,
                                          image_height, tile_size, bg, tile_capacity)
    img, T = _RasterizeEval3D.apply(
        rows, d, o, offsets, (I, D, image_width, image_height, tile_size, tile_capacity))
    alp = 1.0 - T
    if bg is not None:
        img = img + (1.0 - alp)[..., None] * bg.reshape(I, 1, 1, D)
    return img, alp[..., None]
