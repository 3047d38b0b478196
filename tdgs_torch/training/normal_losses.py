"""Normal-supervision losses (PyTorch port of ``tdgs/training/normal_losses.py``).

- ``calculate_gaussian_splat_normal_differentiable``: the softmax-weighted
  rotation axis that favours the smallest scale, and an anisotropy
  confidence
- ``compute_normal_loss`` (cosine, angular, combined, robust) and
  ``compute_progressive_normal_loss`` (cosine at weight 2)
- ``sample_normals_from_map``: bilinear samples of a normal map at the
  projected centres; its gradient reaches the centres
- ``smooth_normals``: a separable gaussian blur of a normal map
- ``depth_smoothness_loss``, ``normal_consistency_loss`` and
  ``normal_total_variation`` (the trainer's term on the depth normals)
- ``render_normals_simple`` / ``render_normals_with_interpolation``: point
  splats of the normals, for viewing
- ``cluster_gaussians_by_surface``, ``apply_surface_consistency_loss`` and
  ``add_spatial_smoothness_loss``
- ``masked_progressive_normal_loss``: the trainer's monocular-normal term

Convolutions run in true float32 (``tdgs_torch`` turns TF32 off). The
|x| of a differentiated term has JAX's gradient +1 at 0 (``_abs``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tdgs_torch.ops.transforms import quat_to_rotmat


def _safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is +1, as JAX differentiates ``abs``
    (``Tensor.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def calculate_gaussian_splat_normal_differentiable(
    quats: torch.Tensor,  # [N, 4] or [N, 3, 3]
    scales: torch.Tensor,  # [N, 3] after activation
    opacities: Optional[torch.Tensor] = None,  # [N]
    temperature: float = 0.01,
    sharpness: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (normals [N, 3], confidence [N]): the rotation's axes weighted by a
    sharp softmax of the inverse scales, normalized; the confidence grows
    with max/min scale (clipped to [0, 1]), times the opacity if given."""
    R = quat_to_rotmat(quats) if quats.shape[-1] == 4 else quats
    inv_scores = sharpness / (scales + 1e-8)
    weights = torch.softmax(inv_scores / temperature, dim=1)  # [N, 3]
    normals = _safe_normalize((R * weights[:, None, :]).sum(-1), dim=1)

    max_s = scales.max(dim=1).values
    min_s = scales.min(dim=1).values
    confidence = torch.clamp((max_s / (min_s + 1e-8) - 1.0) / 10.0, 0.0, 1.0)
    if opacities is not None:
        confidence = confidence * opacities
    return normals, confidence


def compute_normal_loss(
    gaussian_normals: torch.Tensor,  # [..., 3]
    sampled_normals: torch.Tensor,  # [..., 3]
    loss_type: str = "combined",
) -> torch.Tensor:
    g = _safe_normalize(gaussian_normals)
    s = _safe_normalize(sampled_normals)
    cos = (g * s).sum(-1)
    if loss_type == "cosine":
        return (1.0 - cos).mean()
    if loss_type == "angular":
        c = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
        return torch.arccos(_abs(c)).mean()
    if loss_type == "combined":
        return 0.7 * (1.0 - cos).mean() + 0.3 * ((g - s) ** 2).mean()
    if loss_type == "robust":
        return torch.sqrt(((g - s) ** 2).sum(-1) + 1e-8).mean()
    raise ValueError(loss_type)


def compute_progressive_normal_loss(
    gaussian_normals: torch.Tensor,
    sampled_normals: torch.Tensor,
    iteration: int = 0,
    max_iterations: int = 1,
    confidence: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The cosine loss at weight 2 (the schedule's other stages are never
    reached, as in the JAX package)."""
    del iteration, max_iterations, confidence
    return 2.0 * compute_normal_loss(gaussian_normals, sampled_normals, "cosine")


def sample_normals_from_map(
    normal_map: torch.Tensor,  # [H, W, 3]
    means2d: torch.Tensor,  # [N, 2] pixel coords
) -> torch.Tensor:
    """Bilinear samples [N, 3] of a normal map at pixel centres; the
    gradient reaches ``means2d`` through the weights."""
    H, W = normal_map.shape[:2]
    x = torch.clamp(means2d[:, 0] - 0.5, 0.0, W - 1.0)
    y = torch.clamp(means2d[:, 1] - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    top = normal_map[y0, x0] * (1 - fx) + normal_map[y0, x1] * fx
    bot = normal_map[y1, x0] * (1 - fx) + normal_map[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def smooth_normals(normals: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Separable gaussian blur (σ = kernel_size / 6, taps on [-3, 3]) of a
    normal map [H, W, 3], edge-padded."""
    sigma = kernel_size / 6.0
    x = torch.linspace(-3, 3, kernel_size, dtype=normals.dtype, device=normals.device)
    k = torch.exp(-(x**2) / (2 * sigma**2))
    k = k / k.sum()
    H, W = normals.shape[:2]
    img = normals.permute(2, 0, 1).reshape(3, 1, H, W)
    pad = kernel_size // 2
    img = F.pad(img, (pad, pad, pad, pad), mode="replicate")
    img = F.conv2d(img, k.reshape(1, 1, kernel_size, 1))
    img = F.conv2d(img, k.reshape(1, 1, 1, kernel_size))
    return img.reshape(3, H, W).permute(1, 2, 0)


def depth_smoothness_loss(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of a depth map [H, W, 1]: its differences
    weighted by exp(−mean |image difference|)."""
    dz_dx = _abs(depth[:, 1:, :] - depth[:, :-1, :])
    dz_dy = _abs(depth[1:, :, :] - depth[:-1, :, :])
    di_dx = (image[:, 1:, :] - image[:, :-1, :]).abs().mean(-1, keepdim=True)
    di_dy = (image[1:, :, :] - image[:-1, :, :]).abs().mean(-1, keepdim=True)
    return (dz_dx * torch.exp(-di_dx)).mean() + (dz_dy * torch.exp(-di_dy)).mean()


def normal_total_variation(normals: torch.Tensor) -> torch.Tensor:
    """Mean |difference| of neighbouring normals [H, W, 3] across and down:
    the trainer's ``normalconsist`` term on the depth map's normals. Where
    two neighbours are equal the gradient goes on into them, as in the JAX
    package, and at a zero cross product of ``depth_to_normal`` (its
    rsqrt(|n|² + 1e-12)) it is large."""
    return (_abs(normals[:, 1:] - normals[:, :-1]).mean()
            + _abs(normals[1:] - normals[:-1]).mean())


def normal_consistency_loss(
    rendered_normals: torch.Tensor,  # [H, W, 3]
    depth_normals: torch.Tensor,  # [H, W, 3]
    alpha: Optional[torch.Tensor] = None,  # [H, W, 1]
) -> torch.Tensor:
    """1 − cos between rendered and depth-derived normals, weighted by the
    detached alpha when given."""
    n1 = _safe_normalize(rendered_normals)
    n2 = _safe_normalize(depth_normals)
    err = 1.0 - (n1 * n2).sum(-1)
    if alpha is not None:
        w = alpha[..., 0].detach()
        return (err * w).sum() / torch.clamp(w.sum(), min=1.0)
    return err.mean()


def _splat_pixels(means2d: torch.Tensor, height: int, width: int):
    """(x, y, valid) of each centre rounded to a pixel; the coordinates of
    the centres outside the image are clipped into it."""
    px = torch.round(means2d).to(torch.int64)
    valid = ((px[:, 0] >= 0) & (px[:, 0] < width)
             & (px[:, 1] >= 0) & (px[:, 1] < height))
    return px[:, 0].clamp(0, width - 1), px[:, 1].clamp(0, height - 1), valid


def render_normals_simple(
    normals: torch.Tensor,  # [N, 3]
    means2d: torch.Tensor,  # [N, 2]
    image_height: int,
    image_width: int,
) -> torch.Tensor:
    """(n + 1)/2 as RGB at each centre's rounded pixel → [H, W, 3]; the
    centres outside the image write zeros at their clipped pixel."""
    x, y, valid = _splat_pixels(means2d, image_height, image_width)
    colors = torch.where(valid[:, None], (normals + 1.0) / 2.0,
                         torch.zeros((), dtype=normals.dtype, device=normals.device))
    img = torch.zeros((image_height, image_width, 3), dtype=normals.dtype,
                      device=normals.device)
    return img.index_put((y, x), colors)


def _box_blur_same(ch: torch.Tensor, k: int) -> torch.Tensor:
    """[H, W] → [H, W]: the mean over a k×k window, zero-padded as XLA's
    "SAME" pads (the odd pixel after)."""
    lo, hi = (k - 1) // 2, k // 2
    x = F.pad(ch[None, None], (lo, hi, lo, hi))
    kernel = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=ch.dtype, device=ch.device)
    return F.conv2d(x, kernel)[0, 0]


def render_normals_with_interpolation(
    normals: torch.Tensor,  # [N, 3]
    means2d: torch.Tensor,  # [N, 2]
    image_height: int,
    image_width: int,
    kernel_size: int = 5,
) -> torch.Tensor:
    """The point splats box-blurred and divided by the blurred coverage, so
    sparse regions keep their brightness, then cut to the dilated
    footprint → [H, W, 3]."""
    img = render_normals_simple(normals, means2d, image_height, image_width)
    x, y, valid = _splat_pixels(means2d, image_height, image_width)
    mask = torch.zeros((image_height, image_width), dtype=img.dtype, device=img.device)
    mask = mask.index_put((y, x), valid.to(img.dtype))
    mask_sum = _box_blur_same(mask, kernel_size)
    covered = mask_sum > 0
    out = []
    for c in range(3):
        sm = _box_blur_same(img[..., c], kernel_size)
        out.append(torch.where(covered, sm / torch.clamp(mask_sum, min=1e-12), sm))
    return torch.stack(out, -1) * covered.to(img.dtype)[..., None]


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 they wrap to."""
    return torch.remainder(v + (1 << 31), 1 << 32) - (1 << 31)


def cluster_gaussians_by_surface(
    means3d: torch.Tensor,  # [N, 3]
    normals: torch.Tensor,  # [N, 3]
    cluster_threshold: float = 0.1,
) -> torch.Tensor:
    """Labels [N] (int32) of the occupied cells of a 6-D grid over [means,
    normals] / threshold: the gaussians of one cell share a label, the
    rank of the cell's hash among the distinct hashes. The hash mixes the
    cell coordinates in 32-bit wrapping arithmetic, as the JAX package
    computes it (its 64-bit integers are off by default)."""
    feats = torch.cat([means3d, normals], dim=-1) / cluster_threshold
    cells = torch.floor(feats).to(torch.int32).to(torch.int64)
    mix = torch.zeros(means3d.shape[0], dtype=torch.int64, device=means3d.device)
    for i in range(6):
        mix = _wrap_int32(mix * 1_000_003 + _wrap_int32(cells[:, i] + (1 << 20)))
    _, labels = torch.unique(mix, sorted=True, return_inverse=True)
    return labels.to(torch.int32)


def apply_surface_consistency_loss(
    gaussian_normals: torch.Tensor,  # [N, 3]
    means3d: torch.Tensor,  # [N, 3]
    weight: float = 0.5,
    cluster_threshold: float = 0.1,
) -> torch.Tensor:
    """weight × the mean cosine distance of each normal to its surface
    cell's mean direction."""
    labels = cluster_gaussians_by_surface(means3d, gaussian_normals,
                                          cluster_threshold).long()
    sums = torch.zeros_like(gaussian_normals).index_add(0, labels, gaussian_normals)
    mean_n = _safe_normalize(sums)[labels]
    cos = (_safe_normalize(gaussian_normals) * mean_n).sum(-1)
    return weight * (1.0 - cos).mean()


def add_spatial_smoothness_loss(
    gaussian_normals: torch.Tensor,  # [N, 3]
    means2d: torch.Tensor,  # [N, 2]
    means3d: torch.Tensor,  # [N, 3]
    k_neighbors: int = 8,
) -> torch.Tensor:
    """Normal smoothness over each gaussian's k nearest neighbours on the
    screen, softmax-weighted by inverse 3D distance; O(N²), so for samples
    of a scene."""
    d2 = ((means2d[:, None, :] - means2d[None, :, :]) ** 2).sum(-1)
    # the k + 1 nearest, less the gaussian itself (distance 0)
    idx = torch.topk(-d2, k_neighbors + 1, dim=1).indices[:, 1:]
    d3 = torch.linalg.vector_norm(means3d[:, None, :] - means3d[idx], dim=-1)  # [N, k]
    w = torch.softmax(1.0 / (d3 + 1e-6), dim=1)
    nn = _safe_normalize(gaussian_normals)
    cos = (nn[:, None, :] * nn[idx]).sum(-1)
    return ((1.0 - cos) * w).mean()


def masked_progressive_normal_loss(
    gaussian_normals: torch.Tensor,  # [N, 3]
    sampled_normals: torch.Tensor,  # [N, 3]
    visible: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """The trainer's monocular-normal term: 2 × the mean cosine distance
    over the gaussians visible in the view."""
    g = _safe_normalize(gaussian_normals)
    s = _safe_normalize(sampled_normals)
    err = 1.0 - (g * s).sum(-1)
    w = visible.to(err.dtype)
    return 2.0 * (err * w).sum() / torch.clamp(w.sum(), min=1.0)
