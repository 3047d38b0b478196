"""Training losses and image metrics (port of ``tdgs/training/losses.py``):
l1, mse, psnr, ssim, the (1−λ)·L1 + λ·(1−SSIM) photometric loss and the
sparse (SfM points) and dense (refined depth maps) depth losses.

SSIM's variance ``E[x²] − E[x]²`` cancels on flat regions. In TF32 (cuDNN's
default for float32 convolutions) it came out negative enough to push the
denominator through zero, the failure the JAX package hit with bf16 passes
on the TPU. So the separable filter's two ``conv2d`` calls run with cuDNN's
TF32 off, in true float32, whatever the global setting.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - (window_size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_separable(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid filter of [B, H, W, C] → [B, Ho, Wo, C],
    in true float32."""
    B, H, W, C = img.shape
    k = window.shape[0]
    x = img.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        x = F.conv2d(x, window.reshape(1, 1, k, 1))
        x = F.conv2d(x, window.reshape(1, 1, 1, k))
    Ho, Wo = x.shape[-2:]
    return x.reshape(B, C, Ho, Wo).permute(0, 2, 3, 1)


def ssim(
    pred: torch.Tensor,  # [..., H, W, C] in [0, 1]
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    max_val: float = 1.0,
) -> torch.Tensor:
    """Single-scale SSIM with an 11×11 gaussian window."""
    H, W, C = pred.shape[-3:]
    p = pred.reshape((-1, H, W, C)).to(torch.float32)
    t = target.reshape((-1, H, W, C)).to(torch.float32)

    win = _gaussian_window(window_size, sigma, p.device)
    mu_p = _filter2d_separable(p, win)
    mu_t = _filter2d_separable(t, win)
    mu_pp = _filter2d_separable(p * p, win)
    mu_tt = _filter2d_separable(t * t, win)
    mu_pt = _filter2d_separable(p * t, win)

    # true variance is ≥ 0; float32 cancellation can leave a small negative
    # residue on flat regions
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    cov = mu_pt - mu_p * mu_t

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    return (num / den).mean()


def d_ssim_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   ssim_lambda: float = 0.2) -> torch.Tensor:
    """(1−λ)·L1 + λ·(1−SSIM)."""
    return (1.0 - ssim_lambda) * l1_loss(pred, target) + ssim_lambda * (
        1.0 - ssim(pred, target)
    )


def depth_loss_sparse(
    render_depth: torch.Tensor,  # [..., H, W, 1]
    points_px: torch.Tensor,  # [..., M, 2] pixel coords of sparse points
    point_depths: torch.Tensor,  # [..., M]
    valid: Optional[torch.Tensor] = None,  # [..., M]
) -> torch.Tensor:
    """L1 in disparity between the rendered depth at the projected SfM
    points and their depths. Pixel coordinates are truncated toward zero
    (an int cast, as the JAX package takes them), then clipped to the
    image."""
    H, W = render_depth.shape[-3:-1]
    x = torch.clamp(points_px[..., 0].to(torch.int64), 0, W - 1)
    y = torch.clamp(points_px[..., 1].to(torch.int64), 0, H - 1)
    flat = render_depth[..., 0].reshape(render_depth.shape[:-3] + (H * W,))
    sampled = torch.gather(flat, -1, (y * W + x).reshape(points_px.shape[:-1]))
    disp = 1.0 / torch.clamp(sampled, min=1e-6)
    disp_gt = 1.0 / torch.clamp(point_depths, min=1e-6)
    err = (disp - disp_gt).abs()
    if valid is not None:
        return (err * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return err.mean()


def depth_loss_dense(
    render_depth: torch.Tensor,  # [..., H, W, 1]
    depth_map: torch.Tensor,  # [..., H, W] ground truth, 0 = invalid
    scene_scale: float = 1.0,
) -> torch.Tensor:
    """Masked L1 in disparity against a refined depth map, times the scene
    scale. Both reciprocals are of a clamped value, so the branch that
    ``where`` drops holds no ``inf`` whose gradient would be NaN."""
    rd = render_depth[..., 0]
    valid = (depth_map > 0.0) & (rd > 0.0)
    zero = torch.zeros((), dtype=rd.dtype, device=rd.device)
    disp_r = torch.where(valid, 1.0 / torch.clamp(rd, min=1e-8), zero)
    disp_g = torch.where(valid, 1.0 / torch.clamp(depth_map, min=1e-8), zero)
    n = torch.clamp(valid.sum().to(rd.dtype), min=1.0)
    return (disp_r - disp_g).abs().sum() / n * scene_scale
