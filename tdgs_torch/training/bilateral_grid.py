"""Learnable bilateral grids for per-image exposure and colour correction
(port of ``tdgs/training/bilateral_grid.py``).

Each training image has a grid [grid_h, grid_w, grid_g, 12] of 3×4 affine
colour transforms over (pixel x, pixel y, luma). ``bilateral_grid_slice``
interpolates it trilinearly at x = (i + ½)/W·(grid_w − 1),
y = (j + ½)/H·(grid_h − 1), z = luma·(grid_g − 1) by explicit gathers of
the eight corners, as the JAX package writes it (``F.grid_sample``'s corner
conventions differ), and applies the affine to the rendered colour.
``total_variation_loss`` regularizes the grids; ``color_correct`` is the
post-hoc least-squares affine fit that eval scores as ``cc_*``.
"""

from __future__ import annotations

import torch

from tdgs_torch._device import DeviceLike, resolve_device

_LUMA = (0.299, 0.587, 0.114)
_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def init_bilateral_grid(n_images: int, grid_w: int = 16, grid_h: int = 16, grid_g: int = 8,
                        device: DeviceLike = None) -> torch.Tensor:
    """Identity affines [n_images, grid_h, grid_w, grid_g, 12]."""
    dev = resolve_device(device)
    ident = torch.tensor(_IDENTITY, dtype=torch.float32, device=dev)
    return ident.expand(n_images, grid_h, grid_w, grid_g, 12).contiguous()


def bilateral_grid_slice(grids: torch.Tensor,  # [n, gh, gw, gg, 12]
                         image_ids: torch.Tensor,  # [B]
                         rgb: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
    """Each image's grid applied to its render [B, H, W, 3]."""
    _, gh, gw, gg, _ = grids.shape
    B, H, W, _ = rgb.shape
    dev = rgb.device
    # the corners by index_select on the flat grids: its backward is an
    # index_add_, where advanced indexing's sorts the pixels' indices
    flat = grids.reshape(-1, 12)
    base = image_ids.long()[:, None, None] * (gh * gw * gg)

    y = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H * (gh - 1)
    x = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W * (gw - 1)
    xx = x[None, None, :].expand(B, H, W)
    yy = y[None, :, None].expand(B, H, W)
    luma = torch.clamp((rgb * rgb.new_tensor(_LUMA)).sum(-1), 0.0, 1.0)
    zz = luma * (gg - 1)

    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, gw - 1)
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, gh - 1)
    z0 = torch.clamp(torch.floor(zz).to(torch.int64), 0, gg - 1)
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    z1 = torch.clamp(z0 + 1, max=gg - 1)
    fx = (xx - x0)[..., None]
    fy = (yy - y0)[..., None]
    fz = (zz - z0)[..., None]

    def at(yi, xi, zi):  # [B, H, W, 12]
        idx = base + (yi * gw + xi) * gg + zi
        return flat.index_select(0, idx.reshape(-1)).reshape(B, H, W, 12)

    c00 = at(y0, x0, z0) * (1 - fz) + at(y0, x0, z1) * fz
    c01 = at(y0, x1, z0) * (1 - fz) + at(y0, x1, z1) * fz
    c10 = at(y1, x0, z0) * (1 - fz) + at(y1, x0, z1) * fz
    c11 = at(y1, x1, z0) * (1 - fz) + at(y1, x1, z1) * fz
    c0 = c00 * (1 - fx) + c01 * fx
    c1 = c10 * (1 - fx) + c11 * fx
    aff = (c0 * (1 - fy) + c1 * fy).reshape(B, H, W, 3, 4)
    return (aff[..., :3] * rgb[..., None, :]).sum(-1) + aff[..., 3]


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Σ over the three grid axes of the mean squared forward difference."""
    tv = grids.new_zeros(())
    for axis in (1, 2, 3):
        tv = tv + (torch.diff(grids, dim=axis) ** 2).mean()
    return tv


def color_correct(img: torch.Tensor,  # [..., H, W, 3] prediction
                  ref: torch.Tensor) -> torch.Tensor:  # [..., H, W, 3] ground truth
    """The least-squares affine colour map img → ref over all pixels (4×4
    normal equations with a 1e-6 ridge), applied to img and clipped to
    [0, 1]. The products are taken as sums of elementwise products, so they
    stay in true float32 whatever ``matmul.allow_tf32`` says."""
    shape = img.shape
    x = img.reshape(-1, 3)
    y = ref.reshape(-1, 3)
    A = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)  # [M, 4]
    AtA = (A[:, :, None] * A[:, None, :]).sum(0) + 1e-6 * torch.eye(4, device=A.device)
    AtY = (A[:, :, None] * y[:, None, :]).sum(0)
    Wm = torch.linalg.solve(AtA, AtY)  # [4, 3]
    out = (A[:, :, None] * Wm[None]).sum(1)
    return torch.clamp(out.reshape(shape), 0.0, 1.0)
