"""Single-device 3DGS and 2DGS trainer (port of
``tdgs/training/trainer.py``: ``make_lr_schedules`` :33, ``SplatOptimizer``
:56 and the single-device paths of ``Runner`` :97).

One training step: splat activations → ``rasterization(rasterizer=
"packed")`` with the screen-space taps (projection, SH, tile sort, then the
forward kernel; backward kernel and segment-sum kernel under autograd; or,
with ``Config.rasterizer`` "pallas", the dense tiling and kernels 9 and 10,
or "jax", their plain tensor form) →
(1−λ)·L1 + λ·(1−SSIM) → gradients → selective Adam without bias correction
→ DefaultStrategy accumulation and refine. With ``model_type="2dgs"`` the
render is ``rasterization_2dgs`` in "RGB+ED" (kernels 5 and 6, the segment
sum) and the loss adds the normal-consistency and distortion terms.
With ``with_eval3d`` (3DGUT) the render is the world-space
``"eval3d_packed"`` rasterizer (kernels 7 and 8, the segment sum), tiled by
the UT projection with ``with_ut``, and without the screen-space taps;
3DGUT trains with the MCMCStrategy (relocation, 5% growth up to
``cap_max``, position noise every step).
Gaussian state is the JAX package's fixed-capacity layout (dead rows
padded), and capacity may double between steps (``maybe_grow_capacity``).
Everything runs eagerly in PyTorch on the runner's device; random draws
come from one ``torch.Generator``. Eval renders the test views through the
forward-only ``packed_inference`` rasterizer (kernel 7's forward-only call
under eval3d) and reports PSNR and SSIM (LPIPS is not ported).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.datasets import Dataset, Parser
from tdgs_torch.models import gaussians as G
from tdgs_torch.ops.adam import adam_moments
from tdgs_torch.rendering import rasterization, rasterization_2dgs
from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy
from tdgs_torch.strategy.ops import pad_rows, tree_map
from tdgs_torch.training import losses as L
from tdgs_torch.training.config import Config


def make_lr_schedules(cfg: Config, scene_scale: float, max_steps: int):
    """Per-param learning rates; means decay exponentially to 1%; all
    scaled by sqrt(batch_size)."""
    bs_scale = math.sqrt(cfg.batch_size)

    def means_lr(step):
        init = cfg.means_lr * scene_scale * bs_scale
        return init * (0.01 ** (step / max_steps))

    return {
        "means": means_lr,
        "scales": cfg.scales_lr * bs_scale,
        "quats": cfg.quats_lr * bs_scale,
        "opacities": cfg.opacities_lr * bs_scale,
        "sh0": cfg.sh0_lr * bs_scale,
        "shN": cfg.shN_lr * bs_scale,
        "identity_encodings": cfg.identity_lr * bs_scale,
        "features": cfg.sh0_lr * bs_scale,
        "colors": cfg.sh0_lr * bs_scale,
    }


class SplatOptimizer:
    """Per-param selective Adam without bias correction: one moment dict
    per parameter (``{"mu": ..., "nu": ...}``), the learning rate of each
    name resolved per step."""

    def __init__(self, cfg: Config, scene_scale: float, max_steps: int,
                 b1=0.9, b2=0.999, eps=1e-15):
        self.lrs = make_lr_schedules(cfg, scene_scale, max_steps)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: G.SplatParams):
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def lr_at(self, step: int) -> Dict[str, float]:
        return {k: (v(step) if callable(v) else v) for k, v in self.lrs.items()}

    @torch.no_grad()
    def update(self, grads, state, params, lr_dict, visibility=None):
        """→ (params, state): ``p − lr·m/(√v + eps)``; rows outside
        ``visibility`` keep their value and moments."""
        new_mu, new_nu, new_params = {}, {}, {}
        for name, g in grads.items():
            mu, nu, vis = adam_moments(g, state["mu"][name], state["nu"][name],
                                       self.b1, self.b2, visibility)
            step = -lr_dict[name] * mu / (torch.sqrt(nu) + self.eps)
            if vis is not None:
                step = torch.where(vis, step, torch.zeros_like(step))
            new_mu[name], new_nu[name] = mu, nu
            new_params[name] = params[name] + step
        return new_params, {"mu": new_mu, "nu": new_nu}


class _MetricsLog:
    """Append-only JSONL scalar log (``metrics.jsonl``)."""

    def __init__(self, result_dir: str):
        self.path = os.path.join(result_dir, "metrics.jsonl")

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items() if v is not None})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class Runner:
    """Training runner for single-device 3DGS (screen-space or 3DGUT) or
    2DGS, with the DefaultStrategy or the MCMCStrategy."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        cfg = cfg.adjusted()
        cfg.check_ported()
        self.cfg = cfg
        self.device = resolve_device(device)
        os.makedirs(cfg.result_dir, exist_ok=True)
        self.stats_dir = os.path.join(cfg.result_dir, "stats")
        self.ckpt_dir = os.path.join(cfg.result_dir, "ckpts")
        os.makedirs(self.stats_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger = _MetricsLog(cfg.result_dir)

        self.parser = Parser(cfg.data_dir, factor=cfg.data_factor,
                             normalize=cfg.normalize_world_space,
                             test_every=cfg.test_every)
        self.trainset = Dataset(self.parser, "train", patch_size=cfg.patch_size)
        self.valset = Dataset(self.parser, "val")
        self.scene_scale = (self.parser.scene_scale * 1.1 * cfg.init_extent / 3.0
                            * cfg.global_scale)

        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.splats = self._init_splats()
        self.capacity = self.splats["means"].shape[0]
        self.optimizer = SplatOptimizer(cfg, self.scene_scale, cfg.max_steps)
        self.opt_state = self.optimizer.init(self.splats)
        self.strategy = cfg.strategy
        self.strategy.check_sanity(self.splats)
        if isinstance(self.strategy, MCMCStrategy):
            self.strategy_state = self.strategy.initialize_state(
                self.splats, n_alive=self.n_init)
        else:
            self.strategy_state = self.strategy.initialize_state(
                self.splats, scene_scale=self.scene_scale)

    # ------------------------------------------------------------------
    def _init_splats(self) -> G.SplatParams:
        cfg = self.cfg
        dev = self.device
        if cfg.init_type == "sfm":
            pts_np, rgbs_np = self.parser.points, self.parser.points_rgb
            if cfg.sfm_max_points and pts_np.shape[0] > cfg.sfm_max_points:
                keep = np.random.default_rng(cfg.seed).choice(
                    pts_np.shape[0], cfg.sfm_max_points, replace=False)
                pts_np, rgbs_np = pts_np[keep], rgbs_np[keep]
            pts = torch.as_tensor(pts_np, dtype=torch.float32, device=dev)
            rgbs = torch.as_tensor(rgbs_np / 255.0, dtype=torch.float32, device=dev)
        else:
            pts = ((torch.rand((cfg.init_num_pts, 3), generator=self.generator, device=dev)
                    * 2 - 1) * cfg.init_extent * self.parser.scene_scale)
            rgbs = None
        n_init = pts.shape[0]
        self.n_init = n_init
        capacity = cfg.capacity
        if capacity is None:
            capacity = (cfg.strategy.cap_max if isinstance(cfg.strategy, MCMCStrategy)
                        else 4 * n_init)
        return G.create_splats(
            pts, rgbs, self.generator, sh_degree=cfg.sh_degree,
            init_opacity=cfg.init_opa, init_scale_mult=cfg.init_scale,
            n_max=max(capacity, n_init),
        )

    # ------------------------------------------------------------------
    def rasterize_splats(self, params, viewmats, Ks, width, height, sh_degree,
                         means2d_offset=None, means2d_abs_tap=None,
                         backgrounds=None, render_mode="RGB",
                         rasterizer: Optional[str] = None):
        """Render ``params`` to the cameras; ``rasterizer`` defaults to the
        config's (``"auto"`` is the differentiable ``"packed"``). With
        ``with_eval3d`` every render is ``"eval3d_packed"``, and the
        screen-space taps are dropped: that render never reads means2d."""
        cfg = self.cfg
        means, quats, scales, opacities, sh = G.splat_activations(params)
        if rasterizer is None:
            rasterizer = "packed" if cfg.rasterizer == "auto" else cfg.rasterizer
        if cfg.model_type == "2dgs":
            # eval and render only: the 2DGS train step renders in _loss_2dgs
            out = rasterization_2dgs(
                means, quats, scales, opacities, sh, viewmats, Ks, width, height,
                sh_degree=sh_degree, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                render_mode=render_mode, backgrounds=backgrounds,
                tile_capacity=cfg.tile_capacity, isect_capacity=cfg.isect_capacity,
                max_tiles_per_gauss=cfg.max_tiles_per_gauss, isect_exact=cfg.isect_exact,
                rasterizer=rasterizer, device=self.device,
            )
            return out[0], out[1], out[6]
        if cfg.with_eval3d:
            means2d_offset = means2d_abs_tap = None
        return rasterization(
            means, quats, scales, opacities, sh, viewmats, Ks, width, height,
            sh_degree=sh_degree, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            camera_model=cfg.camera_model,
            rasterize_mode="antialiased" if cfg.antialiased else "classic",
            rasterizer=rasterizer, tile_capacity=cfg.tile_capacity,
            isect_capacity=cfg.isect_capacity,
            max_tiles_per_gauss=cfg.max_tiles_per_gauss, isect_exact=cfg.isect_exact,
            means2d_offset=means2d_offset, means2d_abs_tap=means2d_abs_tap,
            backgrounds=backgrounds, render_mode=render_mode, with_ut=cfg.with_ut,
            with_eval3d=cfg.with_eval3d, device=self.device,
        )

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor], step: int, sh_degree: int):
        """One step: render, loss, gradients, selective Adam. Updates the
        splats and moments; returns (loss tensor, aux) with aux["radii"],
        aux["visibility"] and aux["v_means2d"] (None without the
        DefaultStrategy)."""
        cfg = self.cfg
        images = batch["image"]
        B, H, W = images.shape[:3]
        dev = self.device
        if cfg.random_bkgd:
            backgrounds = torch.rand((B, 3), generator=self.generator, device=dev)
        elif cfg.background_color is not None:
            backgrounds = torch.tensor(cfg.background_color, dtype=torch.float32,
                                       device=dev).expand(B, 3)
        else:
            backgrounds = None
        # eval3d renders give no screen-space gradients (means2d only tiles)
        use_tap = isinstance(self.strategy, DefaultStrategy) and not cfg.with_eval3d
        use_absgrad = use_tap and self.strategy.absgrad

        params = {k: v.detach().requires_grad_(True) for k, v in self.splats.items()}
        C = self.capacity
        taps = []
        tap = abs_tap = None
        if use_tap:
            tap = torch.zeros((B, C, 2), device=dev, requires_grad=True)
            taps.append(tap)
        if use_absgrad:
            abs_tap = torch.zeros((B, C, 2), device=dev, requires_grad=True)
            taps.append(abs_tap)
        if cfg.model_type == "2dgs":
            loss, meta = self._loss_2dgs(params, batch, step, sh_degree, tap, abs_tap,
                                         backgrounds)
        else:
            img, _, meta = self.rasterize_splats(
                params, batch["viewmat"], batch["K"], W, H, sh_degree,
                means2d_offset=tap, means2d_abs_tap=abs_tap, backgrounds=backgrounds)
            if "mask" in batch:
                img = img * batch["mask"][..., None]
            loss = L.d_ssim_l1_loss(img[..., :3], images, cfg.ssim_lambda)
        if cfg.opacity_reg > 0:
            loss = loss + cfg.opacity_reg * torch.sigmoid(params["opacities"]).abs().mean()
        if cfg.scale_reg > 0:
            loss = loss + cfg.scale_reg * torch.exp(params["scales"]).abs().mean()

        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names] + taps,
                                    allow_unused=True)
        g_params = {k: (g if g is not None else torch.zeros_like(params[k]))
                    for k, g in zip(names, grads)}
        g_taps = grads[len(names):]

        radii = meta["radii"]
        visibility = (radii > 0).all(-1).any(dim=tuple(range(radii.dim() - 2)))
        lr_dict = {k: v for k, v in self.optimizer.lr_at(step).items() if k in params}
        self.splats, self.opt_state = self.optimizer.update(
            g_params, self.opt_state, self.splats, lr_dict,
            visibility=visibility if cfg.visible_adam else None)
        if cfg.max_scale is not None:
            self.splats["scales"] = torch.clamp(self.splats["scales"],
                                                max=float(np.log(cfg.max_scale)))
        v_means2d = None
        if use_tap:
            v_means2d = g_taps[1] if use_absgrad else g_taps[0]
        return loss.detach(), {"radii": radii, "visibility": visibility,
                               "v_means2d": v_means2d, "lr_means": lr_dict["means"],
                               "n_dropped": meta["n_dropped"]}

    def _loss_2dgs(self, params, batch, step, sh_degree, tap, abs_tap, backgrounds):
        """The 2DGS step's render and losses (``tdgs/training/trainer.py``
        :644-738): an "RGB+ED" render through the differentiable packed
        rasterizer, D-SSIM + L1 on its colours, the normal consistency of
        the surfel normals against the depth map's normals (weighted by the
        detached alpha) and the mean distortion, each weighted by its lambda
        once past its start step."""
        cfg = self.cfg
        images = batch["image"]
        H, W = images.shape[1:3]
        means, quats, scales, opacities, sh = G.splat_activations(params)
        img, alpha, normals, normals_from_depth, distort, _, meta = rasterization_2dgs(
            means, quats, scales, opacities, sh, batch["viewmat"], batch["K"], W, H,
            sh_degree=sh_degree, render_mode="RGB+ED", distloss=cfg.dist_loss,
            means2d_offset=tap, means2d_abs_tap=abs_tap,
            tile_capacity=cfg.tile_capacity, isect_capacity=cfg.isect_capacity,
            max_tiles_per_gauss=cfg.max_tiles_per_gauss, isect_exact=cfg.isect_exact,
            backgrounds=backgrounds, rasterizer="packed", device=self.device,
        )
        if "mask" in batch:
            img = img * batch["mask"][..., None]
        loss = L.d_ssim_l1_loss(img[..., :3], images, cfg.ssim_lambda)
        normal_lambda = cfg.normal_lambda if step > cfg.normal_start_iter else 0.0
        if cfg.normal_loss and normal_lambda:
            nfd = normals_from_depth * alpha.detach()
            loss = loss + normal_lambda * (1.0 - (normals * nfd).sum(-1)).mean()
        dist_lambda = cfg.dist_lambda if step > cfg.dist_start_iter else 0.0
        if cfg.dist_loss and dist_lambda:
            loss = loss + dist_lambda * distort.mean()
        return loss, meta

    def _batch(self, idx) -> Dict[str, torch.Tensor]:
        items = [self.trainset[int(i)] for i in idx]
        dev = self.device
        batch = {
            k: torch.as_tensor(np.stack([it[src] for it in items]), dtype=torch.float32,
                               device=dev)
            for k, src in (("image", "image"), ("viewmat", "viewmat"), ("K", "K"))
        }
        if all("mask" in it for it in items):
            batch["mask"] = torch.as_tensor(np.stack([it["mask"] for it in items]),
                                            dtype=torch.float32, device=dev)
        return batch

    def train(self, start_step: int = 0) -> Dict[str, Any]:
        """Run the training loop from ``start_step`` (after
        ``load_checkpoint``: the schedules are step-indexed; only the data
        order restarts)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + start_step)
        order = rng.permutation(len(self.trainset))
        cursor = 0
        t0 = time.time()
        history = []
        # one record per refine: its step, counts, and alive N around it
        self.refines = []
        for step in range(start_step + 1, cfg.max_steps + 1):
            if cursor + cfg.batch_size > len(order):
                order = rng.permutation(len(self.trainset))
                cursor = 0
            idx = order[cursor:cursor + cfg.batch_size]
            cursor += cfg.batch_size
            batch = self._batch(idx)
            H, W = batch["image"].shape[1:3]
            sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            loss, aux = self.train_step(batch, step, sh_degree)

            info = {"radii": aux["radii"], "width": W, "height": H}
            if aux["v_means2d"] is not None:
                self.strategy_state = self.strategy.update_state(
                    self.strategy_state, info, aux["v_means2d"])
            refine_before = self.strategy.last_refine
            # a device scalar: read (a host sync) only when a refine ran
            alive_before = G.alive_mask(self.splats).sum()
            self.splats, self.opt_state, self.strategy_state = (
                self.strategy.step_post_backward(
                    self.splats, self.opt_state, self.strategy_state, step, info,
                    self.generator, lr=aux["lr_means"]))
            if self.strategy.last_refine is not refine_before:
                self.refines.append(dict(
                    step=step, **self.strategy.last_refine,
                    alive_before=int(alive_before),
                    alive_after=int(G.alive_mask(self.splats).sum())))
            if (cfg.max_capacity and isinstance(self.strategy, DefaultStrategy)
                    and self.strategy.refine_start_iter <= step <= self.strategy.refine_stop_iter
                    and step % self.strategy.refine_every == 0):
                self.maybe_grow_capacity()

            nancheck = int(os.environ.get("TDGS_NANCHECK", "0") or 0)
            if nancheck and step % nancheck == 0 and not math.isfinite(float(loss)):
                bad = {k: int((~torch.isfinite(v)).sum()) for k, v in self.splats.items()
                       if not bool(torch.isfinite(v).all())}
                raise FloatingPointError(f"non-finite loss at step {step}: "
                                         f"non-finite params={bad}")

            if step % cfg.tb_every == 0 or step == cfg.max_steps:
                history.append({"step": step, "loss": float(loss)})
                self.logger.log(step, {
                    "train/loss": float(loss),
                    "train/num_GS": int(G.alive_mask(self.splats).sum()),
                    "train/visible_GS": int(aux["visibility"].sum()),
                    "train/sh_degree": sh_degree,
                })
            if step in cfg.eval_steps:
                self.eval(step)
            if step in cfg.save_steps:
                self.save_checkpoint(step)
            if cfg.save_ply and step in cfg.ply_steps:
                self.export_ply(step)
        return {"history": history, "wall_time_s": time.time() - t0}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        """PSNR and SSIM over the test views, rendered by the forward-only
        ``packed_inference`` rasterizer; writes stats/{stage}_step{step}.json."""
        cfg = self.cfg
        metrics = defaultdict(list)
        t0 = time.time()
        bg = (torch.tensor(cfg.background_color, dtype=torch.float32,
                           device=self.device)[None]
              if cfg.background_color is not None else None)
        for i in range(len(self.valset)):
            d = self.valset[i]
            H, W = d["image"].shape[:2]
            img, _, _ = self.rasterize_splats(
                self.splats, torch.as_tensor(d["viewmat"], device=self.device)[None],
                torch.as_tensor(d["K"], device=self.device)[None], W, H,
                cfg.sh_degree, backgrounds=bg, rasterizer="packed_inference")
            pred = torch.clamp(img[0], 0.0, 1.0)
            if "mask" in d:
                pred = pred * torch.as_tensor(d["mask"], device=self.device)[..., None]
            gt = torch.as_tensor(d["image"], device=self.device)
            metrics["psnr"].append(float(L.psnr(pred, gt)))
            metrics["ssim"].append(float(L.ssim(pred[None], gt[None])))
            if cfg.tb_save_image:
                from tdgs_torch.utils.png import write_png

                both = torch.cat([gt, pred], dim=1).cpu().numpy()
                write_png(os.path.join(self.stats_dir, f"{stage}_step{step}_{i:04d}.png"),
                          (np.clip(both, 0, 1) * 255).astype(np.uint8))
        out = {k: float(np.mean(v)) for k, v in metrics.items()}
        out["ellipse_time"] = (time.time() - t0) / max(len(self.valset), 1)
        out["num_GS"] = int(G.alive_mask(self.splats).sum())
        with open(os.path.join(self.stats_dir, f"{stage}_step{step}.json"), "w") as f:
            json.dump(out, f)
        self.logger.log(step, {f"{stage}/{k}": v for k, v in out.items()})
        return out

    # ------------------------------------------------------------------
    def state_numpy(self, step: int) -> Dict[str, Any]:
        """The checkpoint's content: the JAX package's keys, holding only
        builtins and numpy arrays."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

        return {
            "step": int(step),
            "splats": tree_map(host, self.splats),
            "opt_state": tree_map(host, self.opt_state),
            "strategy_state": tree_map(host, dict(self.strategy_state)),
        }

    def save_checkpoint(self, step: int) -> str:
        """Pickle of step, splats, Adam moments and strategy state."""
        path = os.path.join(self.ckpt_dir, f"ckpt_{step}.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.state_numpy(step), f)
        return path

    def load_state_numpy(self, state: Dict[str, Any]) -> int:
        """Restore from the checkpoint's content (see ``state_numpy``)."""
        def dev(x):
            return torch.as_tensor(x, device=self.device) if isinstance(x, np.ndarray) else x

        self.splats = tree_map(dev, state["splats"])
        self.capacity = self.splats["means"].shape[0]
        self.opt_state = tree_map(dev, state["opt_state"])
        self.strategy_state.update(tree_map(dev, state["strategy_state"]))
        return int(state["step"])

    def load_checkpoint(self, path: str) -> int:
        with open(path, "rb") as f:
            return self.load_state_numpy(pickle.load(f))

    def export_ply(self, step: int) -> str:
        """The alive splats as a standard 3DGS PLY (dead rows dropped)."""
        from tdgs_torch.utils.ply import save_ply

        keep = G.alive_mask(self.splats)
        s = {k: v[keep].detach().cpu().numpy() for k, v in self.splats.items()}
        main = ("means", "scales", "quats", "opacities", "sh0", "shN")
        extra = {k: v for k, v in s.items() if k not in main}
        ply_dir = os.path.join(self.cfg.result_dir, "ply")
        os.makedirs(ply_dir, exist_ok=True)
        out = os.path.join(ply_dir, f"point_cloud_{step}.ply")
        save_ply(out, *(s[k] for k in main), extra=extra or None)
        return out

    def maybe_grow_capacity(self) -> bool:
        """Double the capacity (up to ``max_capacity``) when the alive share
        passes ``capacity_growth_at``: new rows are dead, with zero moments
        and strategy accumulators."""
        cfg = self.cfg
        if not cfg.max_capacity or self.capacity >= cfg.max_capacity:
            return False
        thresh = getattr(self.strategy, "prune_opa", 1.0 / 255.0)
        alive = int((torch.sigmoid(self.splats["opacities"]) > thresh).sum())
        if alive <= cfg.capacity_growth_at * self.capacity:
            return False
        old = self.capacity
        new_cap = min(2 * old, int(cfg.max_capacity))
        if new_cap <= old:
            return False
        self.splats = G.pad_splats(self.splats, new_cap)
        self.opt_state = pad_rows(self.opt_state, old, new_cap)
        self.strategy_state = pad_rows(self.strategy_state, old, new_cap)
        self.capacity = new_cap
        return True
