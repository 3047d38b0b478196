"""Segmentation head: identity encodings → rendered feature space (port of
``tdgs/segmentation/head.py``).

A two-layer MLP ``relu(x @ w1 + b1) @ w2 + b2`` whose parameters keep the
JAX package's names and layout (``w1`` [in, hidden], ``b1`` [hidden],
``w2`` [hidden, out], ``b2`` [out]), so a checkpoint's
``segmentation_head`` dict goes either way unchanged. The weights are
He-normal from a ``torch.Generator``: the same distribution as the JAX
package's, not its bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from tdgs_torch._device import DeviceLike, resolve_device

PARAM_NAMES = ("w1", "b1", "w2", "b2")


class SegmentationHead(nn.Module):
    """The head's four parameters, under the JAX package's names."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_segmentation_head(self.params(), x)

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_NAMES}


def init_segmentation_head(generator: torch.Generator, in_dim: int = 16,
                           hidden: int = 64, out_dim: int = 16,
                           device: DeviceLike = None) -> SegmentationHead:
    """He-normal weights (std √(2/fan_in)), zero biases."""
    dev = resolve_device(device)
    w1 = torch.randn((in_dim, hidden), generator=generator, device=dev) * (2.0 / in_dim) ** 0.5
    w2 = torch.randn((hidden, out_dim), generator=generator, device=dev) * (2.0 / hidden) ** 0.5
    return SegmentationHead(w1, torch.zeros(hidden, device=dev), w2,
                            torch.zeros(out_dim, device=dev))


def apply_segmentation_head(params: Union[SegmentationHead, Mapping[str, torch.Tensor]],
                            x: torch.Tensor) -> torch.Tensor:
    """``relu(x @ w1 + b1) @ w2 + b2`` for a head or a dict of its
    parameters."""
    p = params.params() if isinstance(params, SegmentationHead) else params
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def head_from_numpy(params: Mapping[str, object], device: DeviceLike = None) -> SegmentationHead:
    """A head from a dict of arrays with the four names (a checkpoint's
    ``segmentation_head``)."""
    dev = resolve_device(device)
    return SegmentationHead(*(torch.as_tensor(params[k], dtype=torch.float32, device=dev)
                              .clone() for k in PARAM_NAMES))


def head_to_numpy(head: SegmentationHead) -> Dict[str, object]:
    return {k: v.detach().cpu().numpy() for k, v in head.params().items()}
