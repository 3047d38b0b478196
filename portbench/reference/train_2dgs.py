"""The plain reference of one training step of 2DGS past densification
(gsplat's ``simple_trainer_2dgs.py`` with the ``default`` preset, batch 1,
from ``refine_stop_iter`` on): the photometric loss (1 − λ)·L1 + λ·(1 − SSIM)
of the 3DGS reference, the normal consistency λ_n·mean(1 − n·N) of the
rendered normal n against the expected depth map's normal N times the
detached alpha, and the mean distortion λ_d·mean(Σ_ij w_i w_j |z_i − z_j|),
each term weighted once past its start step; the backward by autograd over
``reference/render_2dgs.py``; selective Adam without bias correction as
``reference/train.py`` has it. Past the strategy's stop no strategy step
runs: no refine, no opacity reset."""

from __future__ import annotations

import torch

from portbench.reference.render_2dgs import render_backward
from portbench.reference.train import adam, learning_rates, photometric_loss


def loss(rgb, alpha, normals, depth_normals, dist, gt, step, ssim_lambda=0.2,
         normal_lambda=0.05, normal_start=7000, dist_lambda=0.01, dist_start=3000,
         rows=None):
    """The step's loss of a view's images (``render_2dgs.render``'s names).
    ``normal_lambda`` or ``dist_lambda`` 0 leaves its term out; ``rows`` < H
    takes the photometric loss over the first rows alone."""
    rows = gt.shape[0] if rows is None else rows
    out = photometric_loss(rgb[:rows], gt[:rows], ssim_lambda)
    if normal_lambda and step > normal_start:
        n_d = depth_normals * alpha.detach()[..., None]
        out = out + normal_lambda * (1.0 - (normals * n_d).sum(-1)).mean()
    if dist_lambda and step > dist_start:
        out = out + dist_lambda * dist.mean()
    return out


def train_step(params, mu, nu, gt, viewmat, K, step, scene_scale, max_steps=30_000,
               ssim_lambda=0.2, normal_lambda=0.05, normal_start=7000, dist_lambda=0.01,
               dist_start=3000, dtype=torch.float32, budget=1 << 24, transposed=False,
               rows=None):
    """One step from (params, Adam moments) with the image ``gt`` [H, W, 3]
    → (params, mu, nu, record): the record holds the loss, the gradients
    as Adam received them, and the rows the view sees with how squarely
    (``render_2dgs.project_2dgs``'s ``facing``). ``transposed`` renders
    with the ray transform read transposed (a planted fault)."""
    H, W = gt.shape[:2]

    def of_images(rgb, alpha, depth, normals, depth_normals, dist):
        del depth
        return loss(rgb, alpha, normals, depth_normals, dist, gt, step, ssim_lambda,
                    normal_lambda, normal_start, dist_lambda, dist_start, rows)

    value, grads, info = render_backward(params, viewmat, K, W, H, of_images, dtype=dtype,
                                         budget=budget, transposed=transposed)
    lr = learning_rates(step, scene_scale, max_steps)
    with torch.no_grad():
        params, mu, nu = adam(params, grads, mu, nu, lr, info["visible"])
    return params, mu, nu, {"loss": float(value), "grads": grads, "visible": info["visible"],
                            "facing": info["facing"], "live_pairs": info["live_pairs"],
                            "entries": info["entries"]}
