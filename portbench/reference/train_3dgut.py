"""The plain reference of one MCMC training step of 3DGUT (gsplat's
``simple_trainer.py mcmc --with_ut --with_eval3d``, batch 1): the 3DGS
reference's step (``reference/train.py``: the photometric loss, both
regularizers, selective Adam without bias correction, MCMC's relocation
and position noise, drawn from the caller's generator in the same order)
around the world-space render of ``reference/render_3dgut.py``; the rows
Adam updates are those the unscented projection keeps."""

from __future__ import annotations

import torch

from portbench.reference.render_3dgut import render_backward
from portbench.reference.train import (
    adam,
    learning_rates,
    photometric_loss,
    position_noise,
    relocate,
)


def train_step(params, mu, nu, gt, viewmat, K, step, generator, scene_scale,
               max_steps=30_000, refine_every=100, refine_start=500, refine_stop=25_000,
               noise_lr=5e5, opacity_reg=0.01, scale_reg=0.01, ssim_lambda=0.2,
               dtype=torch.float32, budget=1 << 24, rows=None, response="closest"):
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
        dtype=dtype, budget=budget, extra_loss=extra, response=response)
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
