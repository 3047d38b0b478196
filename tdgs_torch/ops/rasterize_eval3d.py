"""The dense world-space (eval3d, 3DGUT) rasterizer in plain tensor ops
(port of ``tdgs/ops/rasterize_eval3d.py``, the JAX package's
``rasterizer="eval3d"``).

Each pixel takes the largest response of a gaussian along its true camera
ray, as kernels 7 and 8 do (``rasterize_eval3d_packed``), but over the
dense tiling: every tile gathers its first ``tile_capacity`` entries into
[tiles, capacity] blocks (``gather_tile_gaussians``) and every pixel of the
tile composites the whole block as a prefix product (``composite_prefix``).
The rays come from ``tile_rays_world`` (distortion and rolling shutter
included) and the per-gaussian rows from ``feature_rows`` (M =
diag(1/s)·Rᵀ, g0 = M(o_ref − μ)); in the canonical frame r = M·d,
g = g0 + M·o′ and

    σ* = ½|g × r|² / |r|²,   kept only where g·r < 0 (in front).

The JAX package takes σ* as ½(|g|² − (g·r)²/|r|²), whose two terms are of
size (distance/scale)² and cancel (ROADMAP, faults on the reference side);
the cross product does not. Autograd differentiates it through the tensor
ops, to the gaussians, the colours and opacities, and through the rays to
``viewmats`` and ``viewmats_rs``. It holds [tiles, pixels, capacity]
arrays, so it is meant for small scenes, tests and as an independent
reference of kernels 7 and 8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdgs_torch.ops.camera_models import FThetaCameraDistortionParameters, RollingShutterType
from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.rasterize_eval3d_packed import (
    GEOM_COLS,
    RR_MIN,
    feature_rows,
    tile_rays_world,
)
from tdgs_torch.ops.rasterize_jax import ALPHA_CLAMP, composite_prefix, gather_tile_gaussians
from tdgs_torch.ops.rasterize_packed import untile


def rasterize_to_pixels_eval3d_jax(
    means: torch.Tensor,  # [N, 3] world space
    quats: torch.Tensor,  # [N, 4] wxyz
    scales: torch.Tensor,  # [N, 3]
    colors: torch.Tensor,  # [I, N, D] per camera
    opacities: torch.Tensor,  # [I, N]
    viewmats: torch.Tensor,  # [I, 4, 4] world → camera
    Ks: torch.Tensor,  # [I, 3, 3]
    image_width: int,
    image_height: int,
    tile_size: int,
    isect_offsets: torch.Tensor,  # [I, tile_height, tile_width]
    flatten_ids: torch.Tensor,  # [capacity] → indices into I·N
    n_isects,  # int or 0-d tensor
    camera_model: str = "pinhole",
    radial_coeffs: Optional[torch.Tensor] = None,  # [I, 6] or [I, 4]
    tangential_coeffs: Optional[torch.Tensor] = None,  # [I, 2]
    thin_prism_coeffs: Optional[torch.Tensor] = None,  # [I, 4]
    ftheta_coeffs: Optional[FThetaCameraDistortionParameters] = None,
    backgrounds: Optional[torch.Tensor] = None,  # [I, D]
    tile_capacity: int = 1024,
    rolling_shutter: RollingShutterType = RollingShutterType.GLOBAL,
    viewmats_rs: Optional[torch.Tensor] = None,  # [I, 4, 4] frame-end poses
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (render_colors [I, H, W, D], render_alphas [I, H, W, 1]).
    Under a rolling shutter the tiling must come from the shutter-aware UT
    projection (``rasterization(..., with_ut=True, rolling_shutter=...,
    viewmats_rs=...)``), as for the JAX package."""
    I, N = opacities.shape
    D = colors.shape[-1]
    tile_height, tile_width = isect_offsets.shape[-2:]
    d, o, o_ref = tile_rays_world(
        I, tile_width, tile_height, tile_size, image_width, image_height, viewmats, Ks,
        camera_model, radial_coeffs, tangential_coeffs, thin_prism_coeffs, ftheta_coeffs,
        rolling_shutter, viewmats_rs)  # [T, P, 3], [T, P, 3] or None, [I, 3]
    feats = feature_rows(means, quats, scales, opacities, colors, o_ref)  # [I·N, 13 + D]
    gauss_ids, valid = gather_tile_gaussians(
        isect_offsets.reshape(I, tile_height, tile_width), flatten_ids, n_isects,
        tile_capacity)  # [T, cap]
    f = feats[gauss_ids.long()]  # [T, cap, 13 + D]

    # per (tile, pixel, entry), in the kernels' order of operations
    # (rasterize_eval3d_common.cuh), so that an α near 1/255 lands on the
    # same side here and in kernel 7
    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    col = [f[..., j][:, None, :] for j in range(GEOM_COLS)]  # [T, 1, cap]
    dt = [d[..., k][:, :, None] for k in range(3)]  # [T, P, 1]
    r = [dot3(col[3 * i:3 * i + 3], dt) for i in range(3)]  # M·d
    g = col[9:12]
    if o is not None:
        ot = [o[..., k][:, :, None] for k in range(3)]
        g = [col[9 + i] + dot3(col[3 * i:3 * i + 3], ot) for i in range(3)]
    gr = dot3(g, r)
    c = [g[1] * r[2] - g[2] * r[1], g[2] * r[0] - g[0] * r[2], g[0] * r[1] - g[1] * r[0]]
    rr = torch.clamp(dot3(r, r), min=RR_MIN)
    sigma = 0.5 * (dot3(c, c) / rr)  # [T, P, cap]

    alpha = torch.clamp(col[12] * torch.exp(-sigma), max=ALPHA_CLAMP)
    skip = (gr >= 0.0) | (alpha < ALPHA_THRESHOLD) | ~valid[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    rendered, T_out, _ = composite_prefix(alpha, f[:, None, :, GEOM_COLS:])

    args = (I, tile_width, tile_height, tile_size, image_height, image_width)
    img = untile(rendered, *args)
    alp = 1.0 - untile(T_out[..., None], *args)
    if backgrounds is not None:
        img = img + (1.0 - alp) * backgrounds.reshape(I, 1, 1, D)
    return img, alp
