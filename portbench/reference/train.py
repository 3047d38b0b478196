"""The plain reference of one MCMC training step of 3DGS (gsplat's
``simple_trainer.py`` with the ``mcmc`` preset, batch 1): the photometric
loss (1 − λ)·L1 + λ·(1 − SSIM) with an 11×11 gaussian window (σ 1.5), the
opacity and scale regularizers, selective Adam without bias correction
(β 0.9 / 0.999, ε 1e-15; rows the camera does not see keep value and
moments), then the MCMC strategy of "3D Gaussian Splatting as MCMC"
(arXiv:2404.09591): on a refine step dead gaussians are relocated onto live
ones drawn by opacity (Eq. 9 for the shared opacity and scale), and every
step near-transparent gaussians get noise shaped by their covariance.

The random draws come from a ``torch.Generator`` that the caller seeds
and hands over in the order the method makes them: on a refine step the
multinomial draw of the sources, then every step the position noise."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.render import covariance, render_backward

GROUPS = ("means", "quats", "scales", "opacities", "sh0", "shN")
BASE_LR = {"scales": 5e-3, "quats": 1e-3, "opacities": 5e-2, "sh0": 2.5e-3,
           "shN": 2.5e-3 / 20.0}


def _window(size=11, sigma=1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def _blur(img, win):
    """Valid separable gaussian filter of [H, W, C] → [H−10, W−10, C]."""
    x = img.permute(2, 0, 1)[:, None]
    k = win.shape[0]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        x = F.conv2d(x, win.reshape(1, 1, k, 1))
        x = F.conv2d(x, win.reshape(1, 1, 1, k))
    return x[:, 0].permute(1, 2, 0)


def ssim(a, b):
    win = _window(device=a.device)
    mu_a, mu_b = _blur(a, win), _blur(b, win)
    var_a = torch.clamp(_blur(a * a, win) - mu_a ** 2, min=0)
    var_b = torch.clamp(_blur(b * b, win) - mu_b ** 2, min=0)
    cov = _blur(a * b, win) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


def photometric_loss(rgb, gt, ssim_lambda=0.2):
    return (1 - ssim_lambda) * (rgb - gt).abs().mean() + ssim_lambda * (1 - ssim(rgb, gt))


def learning_rates(step: int, scene_scale: float, max_steps: int) -> Dict[str, float]:
    lr = dict(BASE_LR)
    lr["means"] = 1.6e-4 * scene_scale * 0.01 ** (step / max_steps)
    return lr


def adam(params, grads, mu, nu, lr, visible, b1=0.9, b2=0.999, eps=1e-15):
    """Selective Adam without bias correction, in place of new tensors."""
    out_p, out_m, out_v = {}, {}, {}
    for k in GROUPS:
        vis = visible.reshape((-1,) + (1,) * (grads[k].dim() - 1))
        m = b1 * mu[k] + (1 - b1) * grads[k]
        v = b2 * nu[k] + (1 - b2) * grads[k] ** 2
        out_m[k] = torch.where(vis, m, mu[k])
        out_v[k] = torch.where(vis, v, nu[k])
        step = -lr[k] * out_m[k] / (torch.sqrt(out_v[k]) + eps)
        out_p[k] = params[k] + torch.where(vis, step, torch.zeros_like(step))
    return out_p, out_m, out_v


def relocation(op, scales, n, n_max=51):
    """Eq. 9: a gaussian of opacity ``op`` shared by ``n`` copies → the
    copies' opacity and scale."""
    n = torch.clamp(n, 1, n_max).long()
    new_op = 1 - (1 - op) ** (1.0 / n.to(op.dtype))
    binom = torch.zeros((n_max, n_max), device=op.device)
    for i in range(n_max):
        for k in range(i + 1):
            binom[i, k] = math.comb(i, k)
    j = torch.arange(1, n_max + 1, device=op.device, dtype=op.dtype)
    sign = torch.where(torch.arange(n_max, device=op.device) % 2 == 0, 1.0, -1.0)
    cnj = F.pad(binom[torch.clamp(n, max=n_max - 1)][:, 1:], (0, 1))
    denom = (cnj * sign / torch.sqrt(j) * new_op[:, None] ** j).sum(1)
    coeff = op / torch.where(denom == 0, torch.ones_like(denom), denom)
    return new_op, coeff[:, None] * scales


def relocate(params, mu, nu, generator, min_opacity=0.005, sources=None):
    """One MCMC refine at full capacity: each dead row takes a source drawn
    ∝ opacity among the live rows; source and copies share Eq. 9's opacity
    and scale; every touched row's moments are zeroed. ``sources`` given,
    they replace the draw, which is still made so that the generator moves
    on as it would: on the card the draw itself does not repeat bit for bit
    (its normalising sum is not reproducible, and some of a million
    categories move), but what the generator hands out after it does."""
    op = torch.sigmoid(params["opacities"])
    alive = op > min_opacity
    C = op.shape[0]
    src = torch.multinomial(torch.where(alive, op, torch.zeros_like(op)), C,
                            replacement=True, generator=generator)
    if sources is not None:
        src = sources.to(src.device, torch.long)
    dead = ~alive
    cnt = torch.zeros(C, dtype=torch.long, device=op.device).index_add_(
        0, src, dead.long())
    new_op, new_scale = relocation(op[src], torch.exp(params["scales"][src]), cnt[src] + 1)
    eps = float(torch.finfo(torch.float32).eps)
    new_logit = torch.logit(torch.clamp(new_op, min_opacity, 1 - eps))
    new_log_scale = torch.log(torch.clamp(new_scale, min=1e-12))
    out = {k: v.clone() for k, v in params.items()}
    out["opacities"][src[dead]] = new_logit[dead]
    out["scales"][src[dead]] = new_log_scale[dead]
    for k in GROUPS:
        m = dead.reshape((-1,) + (1,) * (out[k].dim() - 1))
        out[k] = torch.where(m, out[k][src], out[k])
    touched = dead | (cnt > 0)
    zero = {k: torch.where(touched.reshape((-1,) + (1,) * (v.dim() - 1)),
                           torch.zeros_like(v), v) for k, v in mu.items()}
    zero_v = {k: torch.where(touched.reshape((-1,) + (1,) * (v.dim() - 1)),
                             torch.zeros_like(v), v) for k, v in nu.items()}
    return out, zero, zero_v, int(dead.sum())


def position_noise(params, noise, scaler):
    """means += Σ·ε·σ(100·((1 − o) − 0.995))·scaler."""
    op = torch.sigmoid(params["opacities"])
    cov = covariance(params["quats"], torch.exp(params["scales"]))
    gate = torch.sigmoid(100.0 * ((1.0 - op) - 0.995))
    step = (cov @ (noise * gate[:, None] * scaler)[..., None])[..., 0]
    return dict(params, means=params["means"] + step)


def train_step(params, mu, nu, gt, viewmat, K, step, generator, scene_scale,
               max_steps=30_000, refine_every=100, refine_start=500, refine_stop=25_000,
               noise_lr=5e5, opacity_reg=0.01, scale_reg=0.01, ssim_lambda=0.2,
               dtype=torch.float32, budget=1 << 25, rows=None):
    """One step from (params, Adam moments) with the image ``gt`` [H, W, 3]
    → (params, mu, nu, record): the record holds the loss and the
    gradients as Adam received them. ``rows`` < H takes the photometric
    loss over the image's first rows alone (a planted fault: half of the
    batch left out, the mean over the rest)."""
    H, W = gt.shape[:2]
    rows = H if rows is None else rows

    def extra(p):
        return (opacity_reg * torch.sigmoid(p["opacities"]).mean()
                + scale_reg * torch.exp(p["scales"]).mean())

    loss, grads, info = render_backward(
        params, viewmat, K, W, H,
        lambda rgb: photometric_loss(rgb[:rows], gt[:rows], ssim_lambda),
        dtype=dtype, budget=budget, extra_loss=extra)
    lr = learning_rates(step, scene_scale, max_steps)
    with torch.no_grad():
        params, mu, nu = adam(params, grads, mu, nu, lr, info["visible"])
        relocated = None
        if refine_start < step < refine_stop and step % refine_every == 0:
            params, mu, nu, relocated = relocate(params, mu, nu, generator)
        noise = torch.randn(params["means"].shape, generator=generator,
                            device=params["means"].device)
        params = position_noise(params, noise, lr["means"] * noise_lr)
    return params, mu, nu, {"loss": float(loss), "grads": grads,
                            "visible": info["visible"], "live_pairs": info["live_pairs"],
                            "entries": info["entries"], "relocated": relocated}
