"""The plain reference of the 3DGS render: EWA projection, SH colours,
tile binning with the depth order the system defines, and front-to-back
compositing, written from the published method (Kerbl et al., "3D Gaussian
Splatting", SIGGRAPH 2023; gsplat's conventions) in plain tensor operations.

Semantics held to: a pixel's centre is (x + 0.5, y + 0.5); a gaussian
covers the tiles of its bounding box at the radius where its alpha falls
to 1/255; within a tile entries go front to back by depth quantized over the
live depths' span to ``31 - tile_bits`` bits, ties in gaussian order; alpha
is min(0.999, o·exp(-σ)), an entry with σ < 0 or alpha < 1/255 is skipped,
and an entry is composited while the transmittance after it stays above
1e-4. Every tile's entries are composited: nothing is cut.

The backward pass is autograd's, recomputed over the same chunks of tiles,
so no [pixels, entries] block larger than ``budget`` elements is ever
held. ``dtype`` is the precision the compositing runs in (the control runs
it in bfloat16).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
TILE = 16

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions [N, 4], not necessarily unit → rotations [N, 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def covariance(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Σ = R diag(s)² Rᵀ [N, 3, 3] from quats and (positive) scales."""
    M = quat_rotmat(quats) * scales[:, None, :]
    return M @ M.transpose(1, 2)


def project(means, quats, scales, opacities, viewmat, K, width, height,
            near=0.01, far=1e10, eps2d=0.3):
    """Pinhole EWA splatting of N gaussians to one camera.

    → dict of means2d [N, 2], conics [N, 3] (the blurred 2D covariance's
    inverse, (a, b, c)), depths [N], radii [N, 2] (pixels, 0 where the
    gaussian is culled) and valid [N]. The Jacobian is taken at the mean
    clamped to 1.3 times the half field of view, as gsplat clamps it."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    cam = means @ R.T + t
    x, y, z = cam.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-8), z)
    lim_xp = (width - cx) / fx + 0.3 * (0.5 * width / fx)
    lim_xn = cx / fx + 0.3 * (0.5 * width / fx)
    lim_yp = (height - cy) / fy + 0.3 * (0.5 * height / fy)
    lim_yn = cy / fy + 0.3 * (0.5 * height / fy)
    xc = zs * torch.clamp(x / zs, -lim_xn, lim_xp)
    yc = zs * torch.clamp(y / zs, -lim_yn, lim_yp)
    zero = torch.zeros_like(zs)
    J = torch.stack([fx / zs, zero, -fx * xc / (zs * zs),
                     zero, fy / zs, -fy * yc / (zs * zs)], -1).reshape(-1, 2, 3)
    cov_c = R @ covariance(quats, scales) @ R.T
    cov2 = J @ cov_c @ J.transpose(1, 2)
    a = cov2[:, 0, 0] + eps2d
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + eps2d
    det = a * c - b * b
    det_safe = torch.where(det == 0, torch.ones_like(det), det)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    means2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1)

    op = opacities.detach()
    extend = torch.clamp(torch.sqrt(2.0 * torch.log(op.clamp(min=ALPHA_MIN) / ALPHA_MIN)),
                         max=3.33)
    rx = torch.ceil(extend * torch.sqrt(a.detach().clamp(min=0)))
    ry = torch.ceil(extend * torch.sqrt(c.detach().clamp(min=0)))
    m2 = means2d.detach()
    valid = ((det.detach() > 0) & (z.detach() > near) & (z.detach() < far)
             & (op >= ALPHA_MIN) & ((rx > 0) | (ry > 0))
             & (m2[:, 0] + rx > 0) & (m2[:, 0] - rx < width)
             & (m2[:, 1] + ry > 0) & (m2[:, 1] - ry < height))
    radii = torch.where(valid[:, None], torch.stack([rx, ry], -1), torch.zeros_like(m2))
    return {"means2d": means2d, "conics": conics, "depths": z, "radii": radii,
            "valid": valid}


def sh_colors(sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
              degree: int = 3) -> torch.Tensor:
    """RGB [N, 3] = max(Σ_l Y_l(d)·sh_l + 0.5, 0), d the unit direction
    from the camera centre to the mean; sh [N, 16, 3] (real SH, degree ≤ 3)."""
    d = means - campos
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    x, y, z = d[:, :1], d[:, 1:2], d[:, 2:]
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def bin_tiles(means2d, radii, depths, valid, width, height):
    """The front-to-back stream of (tile, gaussian) entries.

    → (tile_of_entry [L], gaussian_of_entry [L], tile starts [T + 1]), the
    entries sorted by (tile, quantized depth), ties in gaussian order."""
    tw, th = math.ceil(width / TILE), math.ceil(height / TILE)
    n_tiles = tw * th
    dev = means2d.device
    m = means2d.detach() / TILE
    r = radii / TILE
    x0 = torch.clamp(torch.floor(m[:, 0] - r[:, 0]), 0, tw).long()
    x1 = torch.clamp(torch.ceil(m[:, 0] + r[:, 0]), 0, tw).long()
    y0 = torch.clamp(torch.floor(m[:, 1] - r[:, 1]), 0, th).long()
    y1 = torch.clamp(torch.ceil(m[:, 1] + r[:, 1]), 0, th).long()
    w = x1 - x0
    cnt = torch.where(valid, w * (y1 - y0), torch.zeros_like(w))
    total = int(cnt.sum())
    owner = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt,
                                    output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0) - cnt)[owner]
    wo = w[owner].clamp(min=1)
    tile = (y0[owner] + k // wo) * tw + x0[owner] + k % wo

    tile_bits = max(math.ceil(math.log2(max(n_tiles, 2))), 1)
    depth_bits = 31 - tile_bits
    levels = (1 << depth_bits) - 2
    d = depths.detach()
    dmin = torch.where(valid, d, torch.full_like(d, math.inf)).min()
    dmax = torch.where(valid, d, torch.full_like(d, -math.inf)).max()
    q = (d - dmin) / torch.clamp(dmax - dmin, min=1e-12) * float(levels)
    q = torch.nan_to_num(q, nan=0.0, posinf=float(levels), neginf=0.0)
    q = torch.clamp(torch.clamp(q, -1.0, levels + 1.0).long(), 0, levels)
    order = torch.sort((tile << depth_bits) | q[owner], stable=True).indices
    tile, owner = tile[order], owner[order]
    starts = torch.searchsorted(tile, torch.arange(n_tiles + 1, device=dev))
    return tile, owner, starts


def _chunks(starts, budget):
    """Groups of tiles (by entry count) whose [tiles, 256, entries] block
    stays under ``budget`` elements."""
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(counts)
    c_sorted = counts[order].tolist()
    ids = order.tolist()
    P = TILE * TILE
    i = 0
    while i < len(ids):
        if c_sorted[i] == 0:
            i += 1
            continue
        j = i
        while j < len(ids) and (j - i + 1) * P * c_sorted[j] <= budget:
            j += 1
        j = max(j, i + 1)
        yield ids[i:j], c_sorted[j - 1]
        i = j


def _composite_chunk(tiles, L, starts, owner, tw, m2, con, col, op, dtype):
    """Composite one chunk of tiles: → (rgb [n, P, D], T [n, P], live
    pairs), differentiable in m2, con, col and op."""
    dev = m2.device
    tt = torch.as_tensor(tiles, device=dev)
    s = starts[tt]
    n_e = starts[tt + 1] - s
    lane = torch.arange(L, device=dev)
    inb = lane[None] < n_e[:, None]
    gid = owner[torch.where(inb, s[:, None] + lane[None], 0)]
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tt % tw) * TILE)[:, None] + (p % TILE)[None] + 0.5
    py = ((tt // tw) * TILE)[:, None] + (p // TILE)[None] + 0.5
    dx = px[:, :, None].to(dtype) - m2[gid][:, None, :, 0].to(dtype)
    dy = py[:, :, None].to(dtype) - m2[gid][:, None, :, 1].to(dtype)
    c = con[gid].to(dtype)
    sigma = 0.5 * (c[:, None, :, 0] * dx * dx + c[:, None, :, 2] * dy * dy) \
        + c[:, None, :, 1] * dx * dy
    alpha = torch.clamp(op[gid].to(dtype)[:, None, :] * torch.exp(-sigma), max=ALPHA_MAX)
    skip = (sigma < 0) | (alpha < ALPHA_MIN) | ~inb[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    keep = T_after > T_MIN
    T_before = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    w = torch.where(keep, alpha * T_before, torch.zeros_like(alpha))
    rgb = torch.einsum("npl,nld->npd", w, col[gid].to(dtype))
    T = torch.where(keep, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)
    live = int((keep & ~skip).sum())
    return tt, rgb, T, live


def _untile(x, tw, th, width, height):
    """[T, 256, C] tile-major → [H, W, C]."""
    C = x.shape[-1]
    img = x.reshape(th, tw, TILE, TILE, C).permute(0, 2, 1, 3, 4)
    return img.reshape(th * TILE, tw * TILE, C)[:height, :width]


def composite(m2, con, col, op, tile_stream, width, height, background=None,
              dtype=torch.float32, grad_rgb=None, budget=1 << 25):
    """Front-to-back compositing of a tile stream.

    Without ``grad_rgb``: → (rgb [H, W, D] float32, alpha [H, W], live
    pairs). With ``grad_rgb`` [H, W, D] (dL/d rgb): the gradients are
    accumulated into the ``.grad`` of whichever of m2, con, col, op require
    them, chunk by chunk, and the same triple is returned."""
    _, owner, starts = tile_stream
    tw, th = math.ceil(width / TILE), math.ceil(height / TILE)
    D = col.shape[-1]
    out = torch.zeros((tw * th, TILE * TILE, D), device=m2.device)
    out_T = torch.ones((tw * th, TILE * TILE), device=m2.device)
    g_tiles = None
    if grad_rgb is not None:
        pad = torch.zeros((th * TILE, tw * TILE, D), device=m2.device)
        pad[:height, :width] = grad_rgb
        g_tiles = pad.reshape(th, TILE, tw, TILE, D).permute(0, 2, 1, 3, 4).reshape(
            tw * th, TILE * TILE, D)
    live = 0
    for tiles, L in _chunks(starts, budget):
        with torch.set_grad_enabled(grad_rgb is not None):
            tt, rgb, T, n_live = _composite_chunk(tiles, L, starts, owner, tw, m2, con,
                                                  col, op, dtype)
            if grad_rgb is not None:
                torch.autograd.backward(rgb.float(), g_tiles[tt])
        out[tt] = rgb.detach().float()
        out_T[tt] = T.detach().float()
        live += n_live
    # live pairs counted inside the image only
    rgb = _untile(out, tw, th, width, height)
    T = _untile(out_T[..., None], tw, th, width, height)[..., 0]
    if background is not None:
        rgb = rgb + T[..., None] * background
    return rgb, 1.0 - T, live


def render(means, quats, scales, opacities, sh, viewmat, K, width, height,
           background=None, sh_degree=3, dtype=torch.float32, budget=1 << 25):
    """A whole forward render of activated parameters (scales positive,
    opacities in (0, 1), sh [N, 16, 3]) → (rgb [H, W, 3], alpha [H, W],
    info: live pairs, entries)."""
    with torch.no_grad():
        pr = project(means, quats, scales, opacities, viewmat, K, width, height)
        campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        col = sh_colors(sh, means, campos, sh_degree)
        stream = bin_tiles(pr["means2d"], pr["radii"], pr["depths"], pr["valid"],
                           width, height)
        rgb, alpha, live = composite(pr["means2d"], pr["conics"], col, opacities, stream,
                                     width, height, background, dtype, budget=budget)
    return rgb, alpha, {"live_pairs": live, "entries": int(stream[0].numel())}


def render_backward(params: Dict[str, torch.Tensor], viewmat, K, width, height,
                    loss_of_rgb, sh_degree=3, dtype=torch.float32, budget=1 << 25,
                    extra_loss=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """Loss and gradients of raw parameters (means, quats, scales as logs,
    opacities as logits, sh0, shN) for one camera.

    ``loss_of_rgb(rgb) -> scalar``; ``extra_loss(params) -> scalar`` adds
    terms of the parameters themselves. → (loss, grads by name, info with
    the visibility mask and the live pairs)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    means, quats = leaves["means"], leaves["quats"]
    scales, opac = torch.exp(leaves["scales"]), torch.sigmoid(leaves["opacities"])
    sh = torch.cat([leaves["sh0"], leaves["shN"]], 1)
    pr = project(means, quats, scales, opac, viewmat, K, width, height)
    campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    col = sh_colors(sh, means, campos, sh_degree)
    col = torch.where(pr["valid"][:, None], col, torch.zeros_like(col))
    stream = bin_tiles(pr["means2d"], pr["radii"], pr["depths"], pr["valid"], width, height)
    mid = {"m2": pr["means2d"], "con": pr["conics"], "col": col, "op": opac}
    det = {k: v.detach().requires_grad_(True) for k, v in mid.items()}
    with torch.no_grad():
        rgb, _, live = composite(det["m2"], det["con"], det["col"], det["op"], stream,
                                 width, height, dtype=dtype, budget=budget)
    rgb_leaf = rgb.clone().requires_grad_(True)
    img_loss = loss_of_rgb(rgb_leaf)
    (g_rgb,) = torch.autograd.grad(img_loss, rgb_leaf)
    composite(det["m2"], det["con"], det["col"], det["op"], stream, width, height,
              dtype=dtype, grad_rgb=g_rgb, budget=budget)
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
