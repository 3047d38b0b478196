"""The plain reference of the 2DGS render: the surfel projection, SH
colours, tile binning in the depth order the system defines, and each
surfel's response where the pixel's ray meets its plane, composited front
to back with the depth channel, the normals and the depth distortion;
written from the published method (Huang et al., "2D Gaussian Splatting
for Geometrically Accurate Radiance Fields", SIGGRAPH 2024,
arXiv:2403.17888; gsplat's conventions) in plain tensor operations.

The surfel: a planar disc with centre p, unit tangent axes t_u, t_v (the
rotation's first two columns) scaled by s_u, s_v, and normal t_w = t_u × t_v
(the rotation's third column; the third scale is not read). In the camera
frame its points are p_c + u·s_u·t_u + v·s_v·t_v, and the homogeneous
pixel of (u, v) is WH·(u, v, 1) with WH = K·[s_u·t_u, s_v·t_v, p_c].

The response (Eqs. 8–9): a pixel x = (x, y) (its centre, +0.5) defines
the planes h_x = (−1, 0, x) and h_y = (0, −1, y), carried to the splat's
frame by h_u = (WH)ᵀ·h_x and h_v = (WH)ᵀ·h_y; they meet at
u = (h_u² h_v³ − h_u³ h_v²)/(h_u¹ h_v² − h_u² h_v¹) and
v = (h_u³ h_v¹ − h_u¹ h_v³)/(h_u¹ h_v² − h_u² h_v¹). The low-pass filter
(Eq. 11) takes max{G(u, v), G(‖x − c‖/σ)} with G(r) = exp(−r²/2) and
σ = √2/2, c the projected centre; alpha = min(0.999, o·Ĝ), an entry with
alpha < 1/255 is skipped, and an entry is composited while the
transmittance after it stays above 1e-4.

The screen box: the disc's rim u² + v² = 1 maps to the conic whose dual is
C* = WH·diag(1, 1, −1)·WHᵀ; its centre is c = (C*₀₂, C*₁₂)/C*₂₂ and its half
extents sqrt(c_k² − C*ₖₖ/C*₂₂); the box is 3.33 of them, rounded up, and the
surfel is kept when C*₂₂ ≠ 0, its depth is in (0.01, 1e10) and its box
reaches the image.

The outputs of a view: the colour, the accumulated depth Σ w·z (z the
centre's camera depth), the alpha, the rendered normal Σ w·n (n the normal
turned toward the camera) and the distortion Σ_i Σ_j w_i w_j |z_i − z_j|
(Eq. 13) over the pixel's composited entries, taken in exact depth order
as 2·Σ_i w_i (z_i·A_i − B_i) with A, B the sums of w and w·z before i. The
expected depth is Σ w·z / alpha; the depth map's normal at a pixel is the
cross product of its unprojected neighbours' differences, down by right
(zero on the border).

Departures from the paper, each gsplat's form: z in the distortion is the
centre's camera depth, not the ray–splat intersection's depth in NDC; the
normal term compares the rendered normal with the normal of the expected
depth map times the detached alpha (``train_2dgs.loss``), where the paper
sums per splat; the depth order within a tile is the system's (the
centre's depth quantized over the live span, ties in gaussian order), the
3DGS reference's ``bin_tiles``; a pixel composites every entry of its
tile: nothing is cut. The normals and the distortion are taken in the
camera frame (the loss's dot products do not see the frame).

The backward pass is autograd's, recomputed chunk by chunk of tiles as the
3DGS reference does, so that no [pixels, entries] block larger than
``budget`` elements is held; ``dtype`` is the precision the response and
the compositing run in (the control runs them in bfloat16).
``transposed=True`` carries the planes by WH in place of (WH)ᵀ: the ray
transform read transposed, a wrong reference for the tests to tell apart.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

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

SIGMA_FILTER = math.sqrt(2.0) / 2.0
EXTENT = 3.33


def project_2dgs(means, quats, scales, viewmat, K, width, height, near=0.01, far=1e10):
    """The surfels of N gaussians against one pinhole camera → dict of WH
    [N, 3, 3], means2d [N, 2] (the centre of the projected rim), depths
    [N] (the centre's camera z), normals [N, 3] (camera frame, toward the
    camera), radii [N, 2], valid [N] and facing [N] (|cos| of the normal
    against the ray to the centre: 0 seen edge-on). Differentiable in WH,
    means2d, depths and normals."""
    Rv, tv = viewmat[:3, :3], viewmat[:3, 3]
    Rc = Rv @ quat_rotmat(quats)  # camera-frame axes as columns
    p_c = means @ Rv.T + tv
    axes = torch.stack([Rc[..., 0] * scales[:, :1], Rc[..., 1] * scales[:, 1:2], p_c], -1)
    WH = K @ axes  # [N, 3, 3]: (u, v, 1) → homogeneous pixel
    n = Rc[..., 2]
    n = torch.where(((n * p_c).sum(-1) < 0)[:, None], n, -n)

    Q = torch.diag(torch.tensor([1.0, 1.0, -1.0], device=means.device, dtype=means.dtype))
    dual = WH @ Q @ WH.transpose(1, 2)
    c22 = dual[:, 2, 2]
    c22s = torch.where(c22 == 0, torch.ones_like(c22), c22)
    centre = dual[:, :2, 2] / c22s[:, None]
    half2 = centre.detach() ** 2 - torch.diagonal(dual.detach(), dim1=1, dim2=2)[:, :2] / \
        c22s.detach()[:, None]
    radii = torch.ceil(EXTENT * torch.sqrt(half2.clamp(min=1e-4)))
    z = p_c[:, 2]
    m = centre.detach()
    valid = ((c22.detach() != 0) & (z.detach() > near) & (z.detach() < far)
             & (m[:, 0] + radii[:, 0] > 0) & (m[:, 0] - radii[:, 0] < width)
             & (m[:, 1] + radii[:, 1] > 0) & (m[:, 1] - radii[:, 1] < height))
    radii = torch.where(valid[:, None], radii, torch.zeros_like(radii))
    facing = (n * p_c).sum(-1).abs().detach() / p_c.detach().norm(dim=-1)
    return {"WH": WH, "means2d": centre, "depths": z, "normals": n, "radii": radii,
            "valid": valid, "facing": facing}


def _composite_chunk(tiles, L, starts, owner, tw, WH, m2, col, nrm, op, dtype, transposed):
    """Composite one chunk of tiles → (tiles, colour and depth [n, P, D],
    normals [n, P, 3], T [n, P], distortion [n, P], live pairs),
    differentiable in WH, m2, col (its last channel the depth), nrm and
    op."""
    dev = WH.device
    tt = torch.as_tensor(tiles, device=dev)
    s = starts[tt]
    n_e = starts[tt + 1] - s
    lane = torch.arange(L, device=dev)
    inb = lane[None] < n_e[:, None]
    gid = owner[torch.where(inb, s[:, None] + lane[None], 0)]
    p = torch.arange(TILE * TILE, device=dev)
    px = (((tt % tw) * TILE)[:, None] + (p % TILE)[None] + 0.5).to(dtype)
    py = (((tt // tw) * TILE)[:, None] + (p // TILE)[None] + 0.5).to(dtype)
    A = WH[gid].to(dtype)  # [n, L, 3, 3]
    if transposed:
        A = A.transpose(-1, -2)
    # h_u = Aᵀ(−1, 0, x): component k is −A[0, k] + x·A[2, k]
    hu = [-A[:, None, :, 0, k] + px[:, :, None] * A[:, None, :, 2, k] for k in range(3)]
    hv = [-A[:, None, :, 1, k] + py[:, :, None] * A[:, None, :, 2, k] for k in range(3)]
    den = hu[0] * hv[1] - hu[1] * hv[0]  # [n, P, L]
    ok = den != 0
    den_s = torch.where(ok, den, torch.ones_like(den))
    u = (hu[1] * hv[2] - hu[2] * hv[1]) / den_s
    v = (hu[2] * hv[0] - hu[0] * hv[2]) / den_s
    g_splat = torch.where(ok, torch.exp(-0.5 * (u * u + v * v)), torch.zeros_like(u))
    c = m2[gid].to(dtype)
    dx = px[:, :, None] - c[:, None, :, 0]
    dy = py[:, :, None] - c[:, None, :, 1]
    g_filter = torch.exp(-0.5 * (dx * dx + dy * dy) / (SIGMA_FILTER * SIGMA_FILTER))
    alpha = torch.clamp(op[gid].to(dtype)[:, None, :] * torch.maximum(g_splat, g_filter),
                        max=ALPHA_MAX)
    skip = (alpha < ALPHA_MIN) | ~inb[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    keep = T_after > T_MIN
    T_before = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    w = torch.where(keep, alpha * T_before, torch.zeros_like(alpha))
    cols = col[gid].to(dtype)  # [n, L, D]
    acc = torch.einsum("npl,nld->npd", w, cols)
    nout = torch.einsum("npl,nld->npd", w, nrm[gid].to(dtype))
    T = torch.where(keep, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)
    dist = distortion(w, torch.where(inb, cols[..., -1], torch.zeros_like(cols[..., -1])))
    live = int((keep & ~skip).sum())
    return tt, acc, nout, T, dist, live


def distortion(w, z):
    """Eq. 13, Σ_i Σ_j w_i w_j |z_i − z_j|, of weights w [n, P, L] and depths
    z [n, L] → [n, P]: in exact depth order, 2·Σ_i w_i (z_i·A_i − B_i) with
    A, B the sums of w and w·z before i."""
    order = torch.argsort(z, dim=-1, stable=True)
    zs = torch.gather(z, 1, order)[:, None, :]
    ws = torch.gather(w, 2, order[:, None, :].expand_as(w))
    before_w = torch.cumsum(ws, -1) - ws
    before_wz = torch.cumsum(ws * zs, -1) - ws * zs
    return 2.0 * (ws * (zs * before_w - before_wz)).sum(-1)


def composite(WH, m2, col, nrm, op, tile_stream, width, height, dtype=torch.float32,
              grads=None, budget=1 << 24, transposed=False):
    """Front-to-back compositing of a tile stream.

    Without ``grads``: → dict of colour and depth ``acc`` [H, W, D]
    (float32, no background), ``normals`` [H, W, 3], ``alpha`` [H, W],
    ``dist`` [H, W], and the live pairs. With ``grads`` (a dict of the
    loss's gradients of the same images): they are carried back into the
    ``.grad`` of whichever of WH, m2, col, nrm, op require them, chunk by
    chunk, and the same is returned."""
    _, owner, starts = tile_stream
    tw, th = math.ceil(width / TILE), math.ceil(height / TILE)
    D = col.shape[-1]
    dev = WH.device
    P = TILE * TILE
    out = {"acc": torch.zeros((tw * th, P, D), device=dev),
           "normals": torch.zeros((tw * th, P, 3), device=dev),
           "T": torch.ones((tw * th, P, 1), device=dev),
           "dist": torch.zeros((tw * th, P, 1), device=dev)}
    g_tiles = None
    if grads is not None:
        g_img = {"acc": grads["acc"], "normals": grads["normals"],
                 "T": -grads["alpha"][..., None], "dist": grads["dist"][..., None]}
        g_tiles = {}
        for k, g in g_img.items():
            pad = torch.zeros((th * TILE, tw * TILE, g.shape[-1]), device=dev)
            pad[:height, :width] = g
            g_tiles[k] = pad.reshape(th, TILE, tw, TILE, -1).permute(0, 2, 1, 3, 4).reshape(
                tw * th, P, -1)
    live = 0
    for tiles, L in _chunks(starts, budget):
        with torch.set_grad_enabled(grads is not None):
            tt, acc, nout, T, dist, n_live = _composite_chunk(
                tiles, L, starts, owner, tw, WH, m2, col, nrm, op, dtype, transposed)
            got = {"acc": acc, "normals": nout, "T": T[..., None], "dist": dist[..., None]}
            if grads is not None:
                torch.autograd.backward([v.float() for v in got.values()],
                                        [g_tiles[k][tt] for k in got])
        for k, v in got.items():
            out[k][tt] = v.detach().float()
        live += n_live
    img = {k: _untile(v, tw, th, width, height) for k, v in out.items()}
    return {"acc": img["acc"], "normals": img["normals"], "alpha": 1.0 - img["T"][..., 0],
            "dist": img["dist"][..., 0], "live_pairs": live}


def depth_normals(depth, K):
    """The camera-frame normals [H, W, 3] of a z-depth map [H, W]: each
    pixel centre unprojected to z·K⁻¹(x + 0.5, y + 0.5, 1), the cross
    product of the vertical and the horizontal central differences,
    normalised, zero on the 1-pixel border (gsplat's ``depth_to_normal``)."""
    H, W = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=depth.dtype) + 0.5,
                            torch.arange(W, device=dev, dtype=depth.dtype) + 0.5,
                            indexing="ij")
    ray = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                       torch.ones_like(xs)], -1)
    pts = depth[..., None] * ray
    down = pts[2:, 1:-1] - pts[:-2, 1:-1]
    right = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = F.normalize(torch.linalg.cross(down, right, dim=-1), dim=-1)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def _setup(means, quats, scales, viewmat, K, width, height):
    pr = project_2dgs(means, quats, scales, viewmat, K, width, height)
    stream = bin_tiles(pr["means2d"], pr["radii"], pr["depths"], pr["valid"], width, height)
    return pr, stream


def render(means, quats, scales, opacities, sh, viewmat, K, width, height, sh_degree=3,
           dtype=torch.float32, budget=1 << 24, transposed=False):
    """A whole forward render of activated parameters (scales positive,
    opacities in (0, 1), sh [N, 16, 3]) → dict of ``rgb`` [H, W, 3],
    ``alpha``, ``depth`` (expected), ``normals`` (rendered, camera frame),
    ``depth_normals`` (camera frame), ``dist``, and the live pairs and
    entries."""
    with torch.no_grad():
        pr, stream = _setup(means, quats, scales, viewmat, K, width, height)
        campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        col = torch.cat([sh_colors(sh, means, campos, sh_degree), pr["depths"][:, None]], -1)
        out = composite(pr["WH"], pr["means2d"], col, pr["normals"], opacities, stream,
                        width, height, dtype, budget=budget, transposed=transposed)
        depth = out["acc"][..., -1] / out["alpha"].clamp(min=1e-10)
        return {"rgb": out["acc"][..., :3], "alpha": out["alpha"], "depth": depth,
                "normals": out["normals"], "depth_normals": depth_normals(depth, K),
                "dist": out["dist"], "live_pairs": out["live_pairs"],
                "entries": int(stream[0].numel())}


def render_backward(params: Dict[str, torch.Tensor], viewmat, K, width, height,
                    loss_of_images: Callable[..., torch.Tensor], sh_degree=3,
                    dtype=torch.float32, budget=1 << 24, transposed=False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """Loss and gradients of raw parameters (means, quats, scales as logs,
    opacities as logits, sh0, shN) for one camera.

    ``loss_of_images(rgb, alpha, depth, normals, depth_normals, dist) ->
    scalar`` takes the view's images as ``render`` names them (the expected
    depth and the depth map's normals computed from the accumulated depth
    and the alpha, inside the loss's graph). → (loss, grads by name, info
    with the visibility mask, each surfel's ``facing``, the live pairs and
    the entries)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    means, quats = leaves["means"], leaves["quats"]
    scales, opac = torch.exp(leaves["scales"]), torch.sigmoid(leaves["opacities"])
    sh = torch.cat([leaves["sh0"], leaves["shN"]], 1)
    pr, stream = _setup(means, quats, scales, viewmat, K, width, height)
    campos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    col = torch.cat([sh_colors(sh, means, campos, sh_degree), pr["depths"][:, None]], -1)
    col = torch.where(pr["valid"][:, None], col, torch.zeros_like(col))
    mid = {"WH": pr["WH"], "m2": pr["means2d"], "col": col, "nrm": pr["normals"], "op": opac}
    det = {k: v.detach().requires_grad_(True) for k, v in mid.items()}
    with torch.no_grad():
        out = composite(det["WH"], det["m2"], det["col"], det["nrm"], det["op"], stream,
                        width, height, dtype, budget=budget, transposed=transposed)
    imgs = {k: out[k].clone().requires_grad_(True) for k in ("acc", "normals", "alpha", "dist")}
    depth = imgs["acc"][..., -1] / imgs["alpha"].clamp(min=1e-10)
    img_loss = loss_of_images(imgs["acc"][..., :3], imgs["alpha"], depth, imgs["normals"],
                              depth_normals(depth, K), imgs["dist"])
    g_imgs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(
        imgs.items(), torch.autograd.grad(img_loss, list(imgs.values()), allow_unused=True))}
    composite(det["WH"], det["m2"], det["col"], det["nrm"], det["op"], stream, width, height,
              dtype, grads=g_imgs, budget=budget, transposed=transposed)
    outs, gs = [], []
    for k in mid:
        if det[k].grad is not None:
            outs.append(mid[k])
            gs.append(det[k].grad)
    torch.autograd.backward(outs, gs)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    visible = (pr["radii"] > 0).all(-1)
    return img_loss.detach(), grads, {"visible": visible, "facing": pr["facing"],
                                      "live_pairs": out["live_pairs"],
                                      "entries": int(stream[0].numel())}
