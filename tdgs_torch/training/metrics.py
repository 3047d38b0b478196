"""Perceptual metric: LPIPS deep-feature distance (PyTorch port of
``tdgs/training/metrics.py``).

Two backends, as in the JAX package:

1. **Learned LPIPS** when AlexNet or VGG weights are on disk: the npz at
   ``TDGS_LPIPS_WEIGHTS``, else ``~/.cache/tdgs/lpips_<net>.npz`` (the
   feature convs ``conv{i}_w``/``conv{i}_b`` in torchvision's order and the
   calibration heads ``lin{i}``; the JAX module's docstring shows how to
   export them). Nothing is downloaded. The eval key is then ``lpips``.
2. **Random-filter proxy** otherwise: LPIPS's architecture (a strided conv
   pyramid, each layer's features unit-normalized over channels, the mean
   squared difference over space, layers weighted alike) over a fixed bank
   of random filters. The port draws its bank from a ``torch.Generator``
   seeded 1717, with the JAX bank's shapes and He scale; it cannot draw
   ``jax.random``'s numbers, so its values are comparable to neither the
   JAX proxy's nor learned LPIPS's (``convert.lpips_filters_from_numpy``
   runs the port on the JAX bank). The eval key is ``lpips_proxy``.

Convolutions run in true float32 (``tdgs_torch`` turns TF32 off).
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, kernel, stride) per stage of the proxy's pyramid
_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (32, 7, 2),
    (64, 5, 2),
    (128, 3, 2),
    (192, 3, 2),
    (192, 3, 2),
)
_SEED = 1717


@functools.lru_cache(maxsize=4)
def _proxy_filters(device: str) -> Tuple[torch.Tensor, ...]:
    """The proxy's bank [c_out, c_in, k, k] per stage, He-scaled."""
    g = torch.Generator(device="cpu").manual_seed(_SEED)
    ws = []
    c_in = 3
    for c_out, k, _ in _STAGES:
        w = torch.randn((c_out, c_in, k, k), generator=g) * (2.0 / (c_in * k * k)) ** 0.5
        ws.append(w.to(device))
        c_in = c_out
    return tuple(ws)


def _same_pad(h: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero padding of XLA's "SAME" for a k×k window at stride s: the output
    is ceil(n / s) long, and the odd pixel of the padding goes after."""
    pads = []
    for n in (h.shape[-1], h.shape[-2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


def _features(x: torch.Tensor, filters: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """x: [B, H, W, 3] in [0, 1] → the proxy's feature maps [B, c, h, w]."""
    h = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
    feats = []
    for w, (_, k, s) in zip(filters, _STAGES):
        h = torch.relu(F.conv2d(_same_pad(h, k, s), w, stride=s))
        feats.append(h)
    return feats


# per net: each conv's (stride, padding), the ReLUs tapped, and the convs
# followed by a max pool (3, 2 for AlexNet; 2, 2 for VGG)
_ALEX = {
    "convs": [(4, 2), (1, 2), (1, 1), (1, 1), (1, 1)],
    "taps": [0, 1, 2, 3, 4],
    "pool_after": {0, 1},
}
_VGG = {
    "convs": [(1, 1)] * 13,
    "taps": [1, 3, 6, 9, 12],  # relu1_2, 2_2, 3_3, 4_3, 5_3
    "pool_after": {1, 3, 6, 9},
}
# LPIPS's input scaling, applied to [-1, 1] images
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _weights_path(net: str) -> Optional[str]:
    p = os.environ.get("TDGS_LPIPS_WEIGHTS")
    if p and os.path.isfile(p):
        return p
    p = os.path.expanduser(f"~/.cache/tdgs/lpips_{net}.npz")
    return p if os.path.isfile(p) else None


@functools.lru_cache(maxsize=4)
def _load_npz(path: str, net: str, device: str):
    arch = _ALEX if net == "alex" else _VGG
    with np.load(path) as z:
        convs = [(torch.as_tensor(np.asarray(z[f"conv{i}_w"], np.float32), device=device),
                  torch.as_tensor(np.asarray(z[f"conv{i}_b"], np.float32), device=device))
                 for i in range(len(arch["convs"]))]
        lins = [torch.as_tensor(np.asarray(z[f"lin{i}"], np.float32), device=device)
                for i in range(len(arch["taps"]))]
    return convs, lins


def _load_learned(net: str, device: str = "cpu"):
    """(convs [(w, b), ...], lins [w, ...]) on ``device``, or None without
    local weights."""
    path = _weights_path(net)
    return None if path is None else _load_npz(path, net, device)


def _unit(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt((f * f).sum(1, keepdim=True) + 1e-10)


def _learned_distance(img0: torch.Tensor, img1: torch.Tensor, net: str) -> torch.Tensor:
    convs, lins = _load_learned(net, str(img0.device))
    arch = _ALEX if net == "alex" else _VGG
    shift = torch.tensor(_SHIFT, device=img0.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=img0.device).reshape(1, 3, 1, 1)
    pool_k = 3 if net == "alex" else 2

    def feats(x):
        h = ((x * 2.0 - 1.0).permute(0, 3, 1, 2) - shift) / scale
        out = []
        for i, ((w, b), (s, p)) in enumerate(zip(convs, arch["convs"])):
            h = torch.relu(F.conv2d(h, w, b, stride=s, padding=p))
            if i in arch["taps"]:
                out.append(h)
            if i in arch["pool_after"]:
                h = F.max_pool2d(h, pool_k, 2)
        return out

    total = 0.0
    for f0, f1, lin in zip(feats(img0), feats(img1), lins):
        d = (_unit(f0) - _unit(f1)) ** 2
        total = total + (d * lin.reshape(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
    return total


def lpips_impl(net: str = "alex") -> str:
    """The backend :func:`lpips` takes: "learned-<net>" with local weights,
    else "random-proxy"."""
    return f"learned-{net}" if _weights_path(net) is not None else "random-proxy"


def lpips(img0: torch.Tensor, img1: torch.Tensor, net: str = "alex",
          filters: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Perceptual distance [B] between [B, H, W, 3] images in [0, 1]: learned
    LPIPS with local weights, else the random-filter proxy (over
    ``filters`` when given, e.g. the JAX package's bank)."""
    if filters is None and _weights_path(net) is not None:
        return _learned_distance(img0, img1, net)
    if filters is None:
        filters = _proxy_filters(str(img0.device))
    total = 0.0
    for f0, f1 in zip(_features(img0, filters), _features(img1, filters)):
        total = total + ((_unit(f0) - _unit(f1)) ** 2).mean(dim=(1, 2, 3))
    return total / len(_STAGES)
