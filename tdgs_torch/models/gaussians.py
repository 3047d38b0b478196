"""Splat parameters and initializers (port of ``tdgs/models/gaussians.py``).

Raw parametrization as in the JAX package: log-scales, logit opacities,
unnormalized wxyz quats, SH split into dc ``sh0`` [N,1,3] and rest
``shN`` [N,K-1,3]. Parameters live in a plain dict of tensors.

The capacity layout is the JAX package's: arrays are padded to a capacity
``n_max`` with dead rows (opacity logit ``DEAD_OPACITY_LOGIT``, whose
sigmoid is below 1/255, so projection culls them), and densification
writes into dead rows instead of growing the arrays. Random draws come from
an explicit ``torch.Generator``; they are not the JAX package's bits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tdgs_torch.ops.sh import SH_C0, num_sh_bases

SplatParams = Dict[str, torch.Tensor]

# sigmoid(-7) ≈ 9.1e-4 < 1/255: a dead gaussian is culled at projection.
DEAD_OPACITY_LOGIT = -7.0

num_sh_coeffs = num_sh_bases


def rgb_to_sh(rgb):
    """Invert the dc band convention color = 0.2821·dc + 0.5."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5


def splat_activations(
    params: SplatParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw params → render inputs: (means, quats, exp(scales),
    sigmoid(opacities), sh [N, K, 3])."""
    sh = torch.cat([params["sh0"], params["shN"]], dim=-2)
    return (
        params["means"],
        params["quats"],
        torch.exp(params["scales"]),
        torch.sigmoid(params["opacities"]),
        sh,
    )


def _logit(x: float) -> float:
    return math.log(x / (1.0 - x))


def knn_mean_dist(points: torch.Tensor, k: int = 3, chunk: int = 256) -> torch.Tensor:
    """Mean distance to the k nearest neighbours (self excluded), from
    squared differences taken directly (not the matrix-product form of
    ``torch.cdist``), in chunks of rows."""
    out = []
    for b in range(0, points.shape[0], chunk):
        block = points[b:b + chunk]
        d2 = ((block[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        # the k+1 smallest include self (distance 0)
        near = torch.topk(d2, min(k + 1, points.shape[0]), dim=-1, largest=False).values
        out.append(torch.sqrt(torch.clamp(near[:, 1:], min=0.0)).mean(-1))
    return torch.cat(out) if out else points.new_zeros((0,))


def create_splats(
    points: torch.Tensor,  # [M, 3] SfM points or other init positions
    rgbs: Optional[torch.Tensor],  # [M, 3] in [0, 1], or None → random
    generator: torch.Generator,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale_mult: float = 1.0,
    n_max: Optional[int] = None,
    identity_dim: int = 0,
    feature_dim: int = 0,
) -> SplatParams:
    """Splats at ``points`` (SfM init), padded with dead rows to ``n_max``:
    scales = log(mean 3-NN distance · mult), opacities = logit(init_opacity),
    quats ≈ identity + 0.1·N(0, 1), sh0 from the colours, shN zero; with
    ``identity_dim`` > 0 also ``identity_encodings`` [M, identity_dim] of
    0.1·N(0, 1), the learnable identity vectors of segmentation; with
    ``feature_dim`` > 0 (appearance optimization) also ``features``
    [M, feature_dim] uniform in [0, 1) and ``colors`` [M, 3], the logit of
    the colours clipped to [1e-4, 1 − 1e-4]."""
    m = points.shape[0]
    n_max = n_max or m
    if n_max < m:
        raise ValueError(f"n_max {n_max} < {m} points")
    dev = points.device
    points = points.to(torch.float32)

    dist = knn_mean_dist(points, k=3)
    scales = torch.log(torch.clamp(dist * init_scale_mult, min=1e-7))[:, None].repeat(1, 3)
    if rgbs is None:
        rgbs = torch.rand((m, 3), generator=generator, device=dev)
    quats = (torch.randn((m, 4), generator=generator, device=dev) * 0.1
             + torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
    K = num_sh_coeffs(sh_degree)
    params: SplatParams = {
        "means": points,
        "quats": quats,
        "scales": scales,
        "opacities": torch.full((m,), _logit(init_opacity), device=dev),
        "sh0": rgb_to_sh(rgbs.to(torch.float32))[:, None, :],
        "shN": torch.zeros((m, K - 1, 3), device=dev),
    }
    if identity_dim > 0:
        params["identity_encodings"] = torch.randn(
            (m, identity_dim), generator=generator, device=dev) * 0.1
    if feature_dim > 0:
        params["features"] = torch.rand((m, feature_dim), generator=generator, device=dev)
        c = torch.clamp(rgbs.to(torch.float32), 1e-4, 1 - 1e-4)
        params["colors"] = torch.log(c / (1 - c))
    return pad_splats(params, n_max)


def create_splats_random(
    generator: torch.Generator,
    n: int,
    scene_scale: float = 1.0,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    n_max: Optional[int] = None,
    device=None,
) -> SplatParams:
    """Positions uniform in [-scene_scale, scene_scale]³, random colours."""
    points = (torch.rand((n, 3), generator=generator, device=device) * 2 - 1) * scene_scale
    return create_splats(points, None, generator, sh_degree=sh_degree,
                         init_opacity=init_opacity, n_max=n_max)


def pad_splats(params: SplatParams, n_max: int) -> SplatParams:
    """Pad every array to ``n_max`` rows; the new rows are dead (opacity
    logit DEAD_OPACITY_LOGIT, log-scale -10, identity quaternion, zeros)."""
    n = params["means"].shape[0]
    pad = n_max - n
    if pad < 0:
        raise ValueError(f"n_max {n_max} < {n}")
    if pad == 0:
        return params
    out = {}
    for name, p in params.items():
        tail = p.new_zeros((pad,) + tuple(p.shape[1:]))
        if name == "opacities":
            tail.fill_(DEAD_OPACITY_LOGIT)
        elif name == "scales":
            tail.fill_(-10.0)
        elif name == "quats":
            tail[:, 0] = 1.0
        out[name] = torch.cat([p, tail])
    return out


def alive_mask(params: SplatParams) -> torch.Tensor:
    """Gaussians whose opacity clears the render threshold."""
    return torch.sigmoid(params["opacities"]) >= (1.0 / 255.0)
