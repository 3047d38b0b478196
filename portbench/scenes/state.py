"""A trained 3DGS state on the rich scene's surfaces, drawn from a seed.

A Mip-NeRF 360 scene at step 5,000 of gsplat's MCMC schedule holds its cap
of gaussians on the surfaces it has found: anisotropic splats about the
size of the local spacing, a tail of larger ones, opacities spread over
(0, 1) with a few percent near 0 (the dead that the next refine
relocates), colours in the DC band and small view-dependent bands. The
means and colours are sampled on the scene's surfaces (numpy, from the
seed); the other parameters are drawn on the device by a
``torch.Generator`` seeded from the same seed, in a few large calls."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.scenes.rich import Surfaces

SH_C0 = 0.28209479177387814


def trained_state(n: int, seed: int, device, spec: Dict) -> Dict[str, torch.Tensor]:
    """Raw parameters of ``n`` gaussians (means, quats, log scales, logit
    opacities, sh0 [n, 1, 3], shN [n, 15, 3]). ``spec`` holds the state's
    shape: ``dead_share``, ``big_share``, ``big_mult``, ``log_scale_sd``,
    ``flatness``, ``shn_sd``, ``surface_jitter``."""
    surf = Surfaces(seed=spec.get("scene_seed", 11), extent=spec.get("extent", 4.0))
    pts = surf.sample(n, np.random.default_rng(seed))
    g = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    means = torch.as_tensor(pts["means"], device=device)
    rgb = torch.as_tensor(pts["colors"], device=device)
    spacing = 2.2 * surf.S / np.sqrt(pts["n_ground"])

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    means = means + randn(n, 3) * (spec["surface_jitter"] * spacing)
    log_s = np.log(spacing) + randn(n, 3) * spec["log_scale_sd"]
    log_s[:, 2] += np.log(spec["flatness"])
    big = rand(n) < spec["big_share"]
    log_s = log_s + big[:, None] * float(np.log(spec["big_mult"]))
    quats = randn(n, 4)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    op = torch.sigmoid(1.0 + 1.5 * randn(n))
    dead = rand(n) < spec["dead_share"]
    op = torch.where(dead, 0.001 + 0.003 * rand(n), op)
    return {
        "means": means.contiguous(),
        "quats": quats.contiguous(),
        "scales": log_s.contiguous(),
        "opacities": torch.logit(op).contiguous(),
        "sh0": ((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
        "shN": (randn(n, 15, 3) * spec["shn_sd"]).contiguous(),
    }
