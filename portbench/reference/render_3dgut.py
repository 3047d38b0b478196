"""The plain reference of the 3DGUT render: the unscented-transform
projection that tiles the gaussians, SH colours, tile binning in the depth
order the system defines, and the world-space response of each gaussian
along each pixel's ray, composited front to back; written from the
published method (Wu et al., "3DGUT: Enabling Distorted Cameras and
Secondary Rays in Gaussian Splatting", arXiv:2412.12507; gsplat's
``UnscentedTransformParameters`` and ``RasterizeToPixelsFromWorld3DGSFwd.cu``)
in plain tensor operations.

The projection (only the tiling reads it): each gaussian's 2n + 1 = 7
sigma points μ and μ ± sqrt(n + λ)·(R·S)ᵢ, with λ = α²(n + κ) − n and
gsplat's defaults α = 1, β = 2, κ = 0 (so λ = 0), go through the pinhole
camera; the 2D mean and covariance are refitted with the weights
w_m0 = λ/(n + λ), w_c0 = w_m0 + 1 − α² + β, wᵢ = 1/(2(n + λ)). The
covariance takes 0.3 on its diagonal (the EWA filter's eps2d); the radius
is where the opacity's alpha falls to 1/255 (at most 3.33 σ); a gaussian
is kept when one sigma point lies in front of the camera, the centre's
depth is in (0.01, 1e10), the determinant is positive and its box reaches
the image widened by 0.1 of its size (``in_image_margin_factor``).

The response: a pixel's ray is o + t·d, o the camera centre −Rᵀt and d
the unit direction through the pixel's centre (x + 0.5, y + 0.5). In the
gaussian's canonical frame, M = diag(1/s)·Rᵀ, the ray is g + t·r with
g = M(o − μ) and r = M·d, and the response is taken at its closest
approach to the centre, σ* = min_t ½|g + t·r|² = ½|g × r|²/|r|² (the
cross product, as gsplat's kernel takes it, with r left unnormalised).
alpha = min(0.999, o·exp(−σ*)); an entry with alpha < 1/255 is skipped;
an entry is composited while the transmittance after it stays above 1e-4.

Departures, each noted: the closest approach counts only in front of the
ray's origin (g·r < 0), as the system's kernels gate it, where the
paper's ray–particle hit interval gates it; the depth order within a tile
is the system's (the centre's depth quantized over the live span, ties in
gaussian order), the 3DGS reference's ``bin_tiles``; a pixel composites
every entry of its tile: nothing is cut.

The backward pass is autograd's, recomputed chunk by chunk of tiles as the
3DGS reference does, so that no [pixels, entries] block larger than
``budget`` elements is held; ``dtype`` is the precision the response and
the compositing run in (the control runs them in bfloat16).
``response="centre_depth"`` takes the response at the ray's point of the
centre's camera depth in place of the closest approach: a wrong reference
for the tests to tell apart.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.render import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_MIN,
    TILE,
    _chunks,
    _untile,
    bin_tiles,
    quat_rotmat,
    sh_colors,
)

# gsplat's UnscentedTransformParameters defaults
UT_ALPHA, UT_BETA, UT_KAPPA = 1.0, 2.0, 0.0
IN_IMAGE_MARGIN = 0.1


def ut_weights(n: int = 3, alpha: float = UT_ALPHA, beta: float = UT_BETA,
               kappa: float = UT_KAPPA) -> Tuple[float, float, float, float]:
    """(λ, w_m0, w_c0, wᵢ) of the scaled unscented transform."""
    lam = alpha * alpha * (n + kappa) - n
    w_m0 = lam / (n + lam)
    return lam, w_m0, w_m0 + (1.0 - alpha * alpha + beta), 1.0 / (2.0 * (n + lam))


def project_ut(means, quats, scales, opacities, viewmat, K, width, height, near=0.01,
               far=1e10, eps2d=0.3):
    """The unscented projection of N gaussians to one pinhole camera →
    dict of means2d [N, 2], depths [N] (the centre's), radii [N, 2]
    (pixels, 0 where culled) and valid [N]. No gradient: it only tiles."""
    with torch.no_grad():
        lam, w_m0, w_c0, w_i = ut_weights()
        L = quat_rotmat(quats) * scales[:, None, :] * math.sqrt(3 + lam)
        axes = L.transpose(1, 2)  # rows: the scaled axes (R·S)ᵢ
        pts = torch.cat([means[:, None], means[:, None] + axes, means[:, None] - axes], 1)
        R, t = viewmat[:3, :3], viewmat[:3, 3]
        cam = pts @ R.T + t  # [N, 7, 3]
        z = cam[..., 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        px = torch.stack([K[0, 0] * cam[..., 0] / zs + K[0, 2],
                          K[1, 1] * cam[..., 1] / zs + K[1, 2]], -1)  # [N, 7, 2]
        w_m = torch.full((7,), w_i, device=means.device)
        w_m[0] = w_m0
        w_c = w_m.clone()
        w_c[0] = w_c0
        mean2d = (w_m[None, :, None] * px).sum(1)
        dev = px - mean2d[:, None]
        cov = (w_c[None, :, None, None] * dev[..., :, None] * dev[..., None, :]).sum(1)
        a = cov[:, 0, 0] + eps2d
        c = cov[:, 1, 1] + eps2d
        det = a * c - cov[:, 0, 1] * cov[:, 1, 0]
        depth = cam[:, 0, 2]
        extend = torch.clamp(torch.sqrt(2.0 * torch.log(
            opacities.clamp(min=ALPHA_MIN) / ALPHA_MIN)), max=3.33)
        rx = torch.ceil(extend * torch.sqrt(a.clamp(min=0)))
        ry = torch.ceil(extend * torch.sqrt(c.clamp(min=0)))
        mx, my = IN_IMAGE_MARGIN * width, IN_IMAGE_MARGIN * height
        valid = ((z > 0).any(-1) & (det > 0) & (depth > near) & (depth < far)
                 & (opacities >= ALPHA_MIN) & ((rx > 0) | (ry > 0))
                 & (mean2d[:, 0] + rx > -mx) & (mean2d[:, 0] - rx < width + mx)
                 & (mean2d[:, 1] + ry > -my) & (mean2d[:, 1] - ry < height + my))
        radii = torch.where(valid[:, None], torch.stack([rx, ry], -1), torch.zeros_like(mean2d))
    return {"means2d": mean2d, "depths": depth, "radii": radii, "valid": valid}


def pixel_rays(viewmat, K, width, height) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origin [3], unit world directions [T, 256, 3] of every tile pixel,
    tile-major)."""
    tw, th = math.ceil(width / TILE), math.ceil(height / TILE)
    dev = viewmat.device
    tt = torch.arange(tw * th, device=dev)
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tt % tw) * TILE)[:, None] + (p % TILE)[None] + 0.5
    py = ((tt // tw) * TILE)[:, None] + (p // TILE)[None] + 0.5
    d = torch.stack([(px - K[0, 2]) / K[0, 0], (py - K[1, 2]) / K[1, 1],
                     torch.ones_like(px, dtype=torch.float32)], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    return -R.T @ t, d @ R


def canonical(means, quats, scales, origin):
    """Per gaussian: M = diag(1/s)·Rᵀ [N, 3, 3] and g = M(o − μ) [N, 3]."""
    M = quat_rotmat(quats).transpose(1, 2) / scales[:, :, None]
    g = (M @ (origin - means)[..., None])[..., 0]
    return M, g


def _composite_chunk(tiles, L, starts, owner, rays, M, g, col, op, dtype, centre=None):
    """Composite one chunk of tiles: → (tiles, rgb [n, P, D], T [n, P], live
    pairs), differentiable in M, g, col and op. ``centre`` = (the centres'
    camera depths [N], the rays' camera-z [T, P]) takes the response at
    the ray's point of the centre's depth in place of the closest
    approach."""
    dev = M.device
    tt = torch.as_tensor(tiles, device=dev)
    s = starts[tt]
    n_e = starts[tt + 1] - s
    lane = torch.arange(L, device=dev)
    inb = lane[None] < n_e[:, None]
    gid = owner[torch.where(inb, s[:, None] + lane[None], 0)]
    d = rays[tt].to(dtype)  # [n, P, 3]
    r = torch.einsum("nlij,npj->npli", M[gid].to(dtype), d)  # [n, P, L, 3]
    gg = g[gid].to(dtype)[:, None].expand_as(r)  # [n, P, L, 3]
    gr = (gg * r).sum(-1)
    if centre is None:
        sigma = 0.5 * (torch.linalg.cross(gg, r) ** 2).sum(-1) / (r * r).sum(-1)
    else:
        depths, dz = centre
        t_c = depths[gid].to(dtype)[:, None, :] / dz[tt].to(dtype)[:, :, None]
        sigma = 0.5 * ((gg + t_c[..., None] * r) ** 2).sum(-1)
    alpha = torch.clamp(op[gid].to(dtype)[:, None, :] * torch.exp(-sigma), max=ALPHA_MAX)
    skip = (gr >= 0) | (alpha < ALPHA_MIN) | ~inb[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    keep = T_after > T_MIN
    T_before = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    w = torch.where(keep, alpha * T_before, torch.zeros_like(alpha))
    rgb = torch.einsum("npl,nld->npd", w, col[gid].to(dtype))
    T = torch.where(keep, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)
    live = int((keep & ~skip).sum())
    return tt, rgb, T, live


def composite(rays, M, g, col, op, tile_stream, width, height, background=None,
              dtype=torch.float32, grad_rgb=None, budget=1 << 24, centre=None):
    """Front-to-back compositing of a tile stream along the rays.

    Without ``grad_rgb``: → (rgb [H, W, D] float32, alpha [H, W], live
    pairs). With ``grad_rgb`` [H, W, D]: the gradients are accumulated into
    the ``.grad`` of whichever of M, g, col, op require them, chunk by
    chunk, and the same triple is returned."""
    _, owner, starts = tile_stream
    tw, th = math.ceil(width / TILE), math.ceil(height / TILE)
    D = col.shape[-1]
    dev = M.device
    out = torch.zeros((tw * th, TILE * TILE, D), device=dev)
    out_T = torch.ones((tw * th, TILE * TILE), device=dev)
    g_tiles = None
    if grad_rgb is not None:
        pad = torch.zeros((th * TILE, tw * TILE, D), device=dev)
        pad[:height, :width] = grad_rgb
        g_tiles = pad.reshape(th, TILE, tw, TILE, D).permute(0, 2, 1, 3, 4).reshape(
            tw * th, TILE * TILE, D)
    live = 0
    # a pair of the walk holds about ten [P, L]-sized terms beside r and g:
    # the 3DGS reference's budget over 4
    for tiles, L in _chunks(starts, budget):
        with torch.set_grad_enabled(grad_rgb is not None):
            tt, rgb, T, n_live = _composite_chunk(tiles, L, starts, owner, rays, M, g, col,
                                                  op, dtype, centre)
            if grad_rgb is not None:
                torch.autograd.backward(rgb.float(), g_tiles[tt])
        out[tt] = rgb.detach().float()
        out_T[tt] = T.detach().float()
        live += n_live
    rgb = _untile(out, tw, th, width, height)
    T = _untile(out_T[..., None], tw, th, width, height)[..., 0]
    if background is not None:
        rgb = rgb + T[..., None] * background
    return rgb, 1.0 - T, live


def _setup(means, quats, scales, opacities, viewmat, K, width, height, response):
    """The projection, the stream, the rays and, for ``centre_depth``, the
    centres' depths beside the rays' camera-z."""
    pr = project_ut(means.detach(), quats.detach(), scales.detach(), opacities.detach(),
                    viewmat, K, width, height)
    stream = bin_tiles(pr["means2d"], pr["radii"], pr["depths"], pr["valid"], width, height)
    origin, rays = pixel_rays(viewmat, K, width, height)
    centre = None
    if response == "centre_depth":
        centre = (pr["depths"], (rays @ viewmat[:3, :3].T)[..., 2])
    elif response != "closest":
        raise ValueError(f"response {response!r}")
    return pr, stream, origin, rays, centre


def render(means, quats, scales, opacities, sh, viewmat, K, width, height,
           background=None, sh_degree=3, dtype=torch.float32, budget=1 << 24,
           response="closest"):
    """A whole forward render of activated parameters (scales positive,
    opacities in (0, 1), sh [N, 16, 3]) → (rgb [H, W, 3], alpha [H, W],
    info: live pairs, entries)."""
    with torch.no_grad():
        pr, stream, origin, rays, centre = _setup(means, quats, scales, opacities, viewmat,
                                                  K, width, height, response)
        M, g = canonical(means, quats, scales, origin)
        col = sh_colors(sh, means, origin, sh_degree)
        rgb, alpha, live = composite(rays, M, g, col, opacities, stream, width, height,
                                     background, dtype, budget=budget, centre=centre)
    return rgb, alpha, {"live_pairs": live, "entries": int(stream[0].numel())}


def render_backward(params: Dict[str, torch.Tensor], viewmat, K, width, height,
                    loss_of_rgb, sh_degree=3, dtype=torch.float32, budget=1 << 24,
                    extra_loss=None, response="closest"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """Loss and gradients of raw parameters (means, quats, scales as logs,
    opacities as logits, sh0, shN) for one camera: the world-space
    response differentiates means, quats and scales directly (no
    screen-space mean).

    ``loss_of_rgb(rgb) -> scalar``; ``extra_loss(params) -> scalar`` adds
    terms of the parameters themselves. → (loss, grads by name, info with
    the visibility mask, the live pairs and the entries)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    means, quats = leaves["means"], leaves["quats"]
    scales, opac = torch.exp(leaves["scales"]), torch.sigmoid(leaves["opacities"])
    sh = torch.cat([leaves["sh0"], leaves["shN"]], 1)
    pr, stream, origin, rays, centre = _setup(means, quats, scales, opac, viewmat, K, width,
                                              height, response)
    M, g = canonical(means, quats, scales, origin)
    col = sh_colors(sh, means, origin, sh_degree)
    col = torch.where(pr["valid"][:, None], col, torch.zeros_like(col))
    mid = {"M": M, "g": g, "col": col, "op": opac}
    det = {k: v.detach().requires_grad_(True) for k, v in mid.items()}
    with torch.no_grad():
        rgb, _, live = composite(rays, det["M"], det["g"], det["col"], det["op"], stream,
                                 width, height, dtype=dtype, budget=budget, centre=centre)
    rgb_leaf = rgb.clone().requires_grad_(True)
    img_loss = loss_of_rgb(rgb_leaf)
    (g_rgb,) = torch.autograd.grad(img_loss, rgb_leaf)
    composite(rays, det["M"], det["g"], det["col"], det["op"], stream, width, height,
              dtype=dtype, grad_rgb=g_rgb, budget=budget, centre=centre)
    outs, gs = [], []
    for k in mid:
        if det[k].grad is not None:
            outs.append(mid[k])
            gs.append(det[k].grad)
    loss = img_loss.detach()
    if extra_loss is not None:
        extra = extra_loss(leaves)
        outs.append(extra)
        gs.append(torch.ones_like(extra))
        loss = loss + extra.detach()
    torch.autograd.backward(outs, gs)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    visible = (pr["radii"] > 0).all(-1)
    return loss, grads, {"visible": visible, "live_pairs": live,
                         "entries": int(stream[0].numel())}
