"""MCMC relocation (port of ``tdgs/ops/relocation.py``): Eq. 9 of "3D
Gaussian Splatting as MCMC" (arXiv:2404.09591). When a gaussian is cloned
into n copies, the new opacity is 1 − (1 − o)^(1/n) and the scale shrinks
by o / Σ_{j=1..n} C(n, j)·(−1)^{j+1}·o_new^j / √j (the double sum of the
paper collapsed by the hockey-stick identity), against a table of binomial
coefficients.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tdgs_torch._device import DeviceLike, resolve_device

N_MAX = 51


def make_binoms(n_max: int = N_MAX, device: DeviceLike = None) -> torch.Tensor:
    """Binomial coefficients [n_max, n_max]: row n holds C(n, 0..n), 0 above."""
    b = torch.zeros((n_max, n_max), dtype=torch.float32)
    for n in range(n_max):
        for k in range(n + 1):
            b[n, k] = math.comb(n, k)
    return b.to(resolve_device(device))


def compute_relocation(
    opacities: torch.Tensor,  # [N] after the sigmoid
    scales: torch.Tensor,  # [N, 3] after the exp
    ratios: torch.Tensor,  # [N] int: copies each gaussian becomes
    binoms: torch.Tensor,  # [n_max, n_max]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (new opacities [N], new scales [N, 3])."""
    n_max = binoms.shape[0]
    ratios = torch.clamp(ratios, 1, n_max).to(torch.int64)
    new_op = 1.0 - torch.pow(1.0 - opacities, 1.0 / ratios.to(opacities.dtype))

    j = torch.arange(1, n_max + 1, dtype=torch.float32, device=opacities.device)
    sign = torch.where(torch.arange(n_max, device=opacities.device) % 2 == 0, 1.0, -1.0)
    powers = torch.pow(new_op[:, None], j)  # [N, n_max]
    # C(n, j) for j = 1..n_max from row n of the table, C(n, n_max) = 0;
    # n = n_max reads row n_max − 1, as the JAX package's clamped gather does
    cnj = torch.nn.functional.pad(binoms[torch.clamp(ratios, max=n_max - 1)][:, 1:], (0, 1))
    denom = (cnj * sign / torch.sqrt(j) * powers).sum(1)
    coeff = opacities / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return new_op, coeff[:, None] * scales
