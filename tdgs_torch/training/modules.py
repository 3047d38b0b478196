"""Camera-pose and appearance optimization (port of
``tdgs/training/modules.py``).

``CameraOptModule``: a per-image SE(3) delta (3 translation, 6D rotation
after Zhou et al. 2019) right-multiplied onto the camera-to-world pose.
``AppearanceOptModule``: a per-image embedding and an MLP of width 64,
depth 2 over ``[embedding, per-gaussian features, SH bases of the view
direction]`` giving a colour per (camera, gaussian). The trainable parts
are ``nn.Module`` parameters; ``nn.Linear`` stores its weight [out, in]
where the JAX package stores ``w{i}`` [in, out], so ``convert.
aux_params_to_numpy`` and ``aux_params_from_numpy`` transpose. Draws come
from an explicit
``torch.Generator``: the same distributions as the JAX package's, not its
bits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.ops.sh import eval_sh_bases, num_sh_bases

_IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation [..., 6] → rotation matrix [..., 3, 3] by Gram-Schmidt
    (rows b1, b2, b3)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def apply_camera_opt(embeds: torch.Tensor,  # [n_images, 9]
                     camtoworlds: torch.Tensor,  # [..., 4, 4]
                     embed_ids: torch.Tensor) -> torch.Tensor:  # [...]
    """camtoworlds ∘ exp(delta): the SE(3) delta of each image
    right-multiplied (``tdgs/training/modules.py:49-64``)."""
    deltas = embeds[embed_ids.long()]  # [..., 9]
    dx, drot = deltas[..., :3], deltas[..., 3:]
    rot = rotation_6d_to_matrix(drot + drot.new_tensor(_IDENTITY_6D))
    top = torch.cat([rot, dx[..., :, None]], dim=-1)  # [..., 3, 4]
    bottom = deltas.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(deltas.shape[:-1] + (1, 4))
    return camtoworlds @ torch.cat([top, bottom], dim=-2)


class CameraOptModule(nn.Module):
    """Per-image pose deltas ``embeds`` [n_images, 9]: zero (the learnable
    corrector), or N(0, std²) from ``generator`` (the fixed perturbation of
    the pose-noise test mode)."""

    def __init__(self, n_images: int, std: float = 0.0,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if std > 0.0:
            embeds = torch.randn((n_images, 9), generator=generator, device=dev) * std
        else:
            embeds = torch.zeros((n_images, 9), device=dev)
        self.embeds = nn.Parameter(embeds)

    def forward(self, camtoworlds: torch.Tensor, embed_ids: torch.Tensor) -> torch.Tensor:
        return apply_camera_opt(self.embeds, camtoworlds, embed_ids)


def camera_opt_reg(embeds: torch.Tensor) -> torch.Tensor:
    """The L2 regularizer on the pose deltas."""
    return (embeds ** 2).mean()


class AppearanceOptModule(nn.Module):
    """Per-image embeddings ``embeds`` [n_images, embed_dim] (zero) and the
    colour MLP over ``[embeds, features, SH bases]`` (in width embed_dim +
    feature_dim + (sh_degree + 1)²): He-normal hidden layers, zero biases,
    and a zero last layer, so training starts from the base colours."""

    def __init__(self, n_images: int, feature_dim: int, embed_dim: int = 16,
                 sh_degree: int = 3, mlp_width: int = 64, mlp_depth: int = 2,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.sh_degree = sh_degree
        self.embeds = nn.Parameter(torch.zeros((n_images, embed_dim), device=dev))
        dims = [embed_dim + feature_dim + num_sh_bases(sh_degree)] + [mlp_width] * mlp_depth + [3]
        layers = []
        for i in range(len(dims) - 1):
            lin = nn.Linear(dims[i], dims[i + 1], device=dev)
            with torch.no_grad():
                if i == len(dims) - 2:
                    lin.weight.zero_()
                else:
                    lin.weight.copy_(torch.randn((dims[i + 1], dims[i]), generator=generator,
                                                 device=dev) * (2.0 / dims[i]) ** 0.5)
                lin.bias.zero_()
            layers.append(lin)
        self.linears = nn.ModuleList(layers)

    def forward(self, features: torch.Tensor,  # [N, feature_dim]
                embed_ids: Optional[torch.Tensor],  # [C] or None
                dirs: torch.Tensor,  # [C, N, 3]
                sh_degree: int) -> torch.Tensor:
        """Colours [C, N, 3] before the sigmoid. ``embed_ids`` None takes a
        zero embedding (eval). Only the first (sh_degree + 1)² bases are
        live; the rest are zero up to the module's degree."""
        C, N = dirs.shape[:2]
        E = self.embeds.shape[-1]
        if embed_ids is None:
            embeds = self.embeds.new_zeros((C, E))
        else:
            embeds = self.embeds[embed_ids.long()]
        dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True),
                                  min=1e-12)
        K, k_use = num_sh_bases(self.sh_degree), num_sh_bases(sh_degree)
        bases = eval_sh_bases(k_use, dirs)
        if k_use < K:
            bases = torch.cat([bases, bases.new_zeros((C, N, K - k_use))], dim=-1)
        h = torch.cat([embeds[:, None, :].expand(C, N, E),
                       features[None].expand(C, N, features.shape[-1]), bases], dim=-1)
        for i, lin in enumerate(self.linears):
            h = lin(h)
            if i + 1 < len(self.linears):
                h = torch.relu(h)
        return h
