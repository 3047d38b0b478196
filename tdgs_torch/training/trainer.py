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
With ``with_segmentation`` each gaussian also carries a learnable identity
vector, and at the ``seg_*`` cadence a segmentation step renders the
segmentation head's features of those vectors through the packed
rasterizer (``override_features``) and takes the CGC loss against the
instance masks and the spatial regularizer. Its parameter gradients are
added to the main step's before the one selective-Adam update (with the
main render's visibility), as the JAX package's separate seg program does;
the head has its own Adam without bias correction (lr 1e-3).
With ``depth_loss`` or ``depth_normal_loss`` the 3DGS render is "RGB+ED"
(kernels 1–3 at four channels, the fourth the expected depth), and the
loss adds, each under its switch and start step: the depth loss against
the refined depth maps (``use_precomputed_depths``) or the tracked SfM
points' depths, the monocular-normal loss (``load_normals``: each
gaussian's differentiable normal against the normal map sampled at its
projected centre), and the edge-aware depth smoothness with the total
variation of the depth map's normals (``depth_normal_loss``).
The optional modules (``Config.pose_opt``, ``pose_noise``, ``app_opt``,
``use_bilateral_grid``) carry the JAX ``Runner``'s auxiliary state: a
learnable per-image pose corrector (``training/modules.py``
``CameraOptModule``, right-multiplied onto each training camera's
camera-to-world pose, after the fixed ``pose_noise`` perturbation), an
appearance module whose MLP colours each (camera, gaussian) from its
``features`` and ``colors`` in place of SH, and per-image bilateral grids
applied to the rendered RGB (``training/bilateral_grid.py``, with a total
variation term); they train with their own Adam (β 0.9/0.999, eps 1e-15,
no bias correction, no visibility mask). Eval with the grids also reports
the colour-corrected ``cc_*`` metrics, and ``run_compression`` scores the
PNG compression's round trip (``compression/``).
Gaussian state is the JAX package's fixed-capacity layout (dead rows
padded), and capacity may double between steps (``maybe_grow_capacity``).
Everything runs eagerly in PyTorch on the runner's device; random draws
come from one ``torch.Generator``. With ``data_prefetch`` the training
images decode on a thread pool a few steps ahead. Eval renders the test
views through the forward-only ``packed_inference`` rasterizer (kernel 7's
forward-only call under eval3d) and reports PSNR, SSIM and LPIPS (learned
with local weights, else the random-filter proxy, ``lpips_proxy``);
``render_traj`` renders a camera path through it.
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
from tdgs_torch.segmentation import head as seg_head_mod
from tdgs_torch.segmentation import losses as seg_losses
from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy
from tdgs_torch.strategy.ops import pad_rows, tree_map
from tdgs_torch.training import bilateral_grid as BG
from tdgs_torch.training import losses as L
from tdgs_torch.training import modules as M
from tdgs_torch.training import normal_losses as NL
from tdgs_torch.training.config import Config
from tdgs_torch.training.metrics import lpips, lpips_impl
from tdgs_torch.utils.depth import depth_to_normal


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
        rec.update({k: float(v) for k, v in scalars.items()
                    if isinstance(v, (int, float, np.generic, torch.Tensor))})
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

        load_masks = (cfg.load_instance_masks if cfg.load_instance_masks is not None
                      else cfg.with_segmentation)
        self.parser = Parser(cfg.data_dir, factor=cfg.data_factor,
                             normalize=cfg.normalize_world_space,
                             test_every=cfg.test_every, load_instance_masks=load_masks,
                             load_normals=cfg.load_normals)
        self.trainset = Dataset(self.parser, "train", patch_size=cfg.patch_size,
                                load_depths=cfg.depth_loss)
        self.valset = Dataset(self.parser, "val")
        if cfg.data_prefetch:
            self.trainset.enable_prefetch()
        self.scene_scale = (self.parser.scene_scale * 1.1 * cfg.init_extent / 3.0
                            * cfg.global_scale)

        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.splats = self._init_splats()
        self.capacity = self.splats["means"].shape[0]
        self.optimizer = SplatOptimizer(cfg, self.scene_scale, cfg.max_steps)
        self.opt_state = self.optimizer.init(self.splats)
        # the identity-vector segmentation head and its Adam moments
        self.seg_head = None
        self.seg_opt_state = None
        self.seg_steps = 0  # steps that ran the segmentation step
        if cfg.with_segmentation:
            self.seg_head = seg_head_mod.init_segmentation_head(
                self.generator, cfg.identity_dim, 64, cfg.identity_dim, device=self.device)
            self.seg_opt_state = self._zero_head_moments()
        self._init_aux(len(self.trainset))
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
            identity_dim=cfg.identity_dim if cfg.with_segmentation else 0,
            feature_dim=cfg.feature_dim if cfg.app_opt else 0,
        )

    def _init_aux(self, n_images: int) -> None:
        """The auxiliary modules of ``tdgs/training/trainer.py:196-244``:
        the pose corrector at zero (lr ``pose_opt_lr``), the fixed pose
        perturbation N(0, ``pose_noise``²) that never trains, the bilateral
        grids at identity (lr 2e-3) and the appearance module (embeddings
        at ``app_opt_lr``·√B·10, the MLP at ``app_opt_lr``·√B), with zero
        Adam moments."""
        cfg, dev = self.cfg, self.device
        self.camera_opt = self.app_module = self.bilagrid = self._pose_perturb = None
        self.aux_lrs: Dict[str, float] = {}
        if cfg.pose_opt:
            self.camera_opt = M.CameraOptModule(n_images, device=dev)
            self.aux_lrs["pose"] = cfg.pose_opt_lr
        if cfg.pose_noise > 0.0:
            self._pose_perturb = M.CameraOptModule(
                n_images, std=cfg.pose_noise, generator=self.generator,
                device=dev).embeds.detach()
        if cfg.use_bilateral_grid:
            gw, gh, gg = cfg.bilateral_grid_shape
            self.bilagrid = torch.nn.Parameter(
                BG.init_bilateral_grid(n_images, gw, gh, gg, device=dev))
            self.aux_lrs["bilagrid"] = 2e-3
        if cfg.app_opt:
            self.app_module = M.AppearanceOptModule(
                n_images, cfg.feature_dim, embed_dim=cfg.app_embed_dim,
                sh_degree=cfg.sh_degree, generator=self.generator, device=dev)
            bs_scale = math.sqrt(cfg.batch_size)
            self.aux_lrs["app_embeds"] = cfg.app_opt_lr * bs_scale * 10.0
            self.aux_lrs["app_mlp"] = cfg.app_opt_lr * bs_scale
        self.aux_opt_state = {part: tree_map(torch.zeros_like, self.aux_params())
                              for part in ("mu", "nu")}

    def aux_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The auxiliary parameters by Adam group, under the JAX Runner's
        ``aux_params`` keys: ``pose`` {embeds}, ``bilagrid`` {grids},
        ``app_embeds`` {embeds}, ``app_mlp`` {the MLP's layers}."""
        groups = {}
        if self.camera_opt is not None:
            groups["pose"] = {"embeds": self.camera_opt.embeds}
        if self.bilagrid is not None:
            groups["bilagrid"] = {"grids": self.bilagrid}
        if self.app_module is not None:
            groups["app_embeds"] = {"embeds": self.app_module.embeds}
            groups["app_mlp"] = dict(self.app_module.linears.named_parameters())
        return groups

    @torch.no_grad()
    def load_aux_state(self, params: Dict[str, Dict[str, torch.Tensor]],
                       opt_state: Optional[Dict] = None) -> None:
        """Set the auxiliary parameters (and their Adam moments) from groups
        shaped as ``aux_params()`` (``convert.aux_params_from_numpy``)."""
        for group, ps in self.aux_params().items():
            for name, p in ps.items():
                p.copy_(params[group][name])
        if opt_state is not None:
            self.aux_opt_state = tree_map(lambda x: x.to(self.device).clone(), opt_state)

    @torch.no_grad()
    def _aux_update(self, grads: Dict[str, Dict[str, Optional[torch.Tensor]]]) -> None:
        """The aux Adam of ``tdgs/training/trainer.py:919-939``: β 0.9/0.999,
        ``p − lr·m/(√v + 1e-15)``, no bias correction, every row."""
        mu, nu = self.aux_opt_state["mu"], self.aux_opt_state["nu"]
        for group, params in self.aux_params().items():
            lr = self.aux_lrs[group]
            for name, p in params.items():
                g = grads[group][name]
                if g is None:
                    g = torch.zeros_like(p)
                mu[group][name] = 0.9 * mu[group][name] + 0.1 * g
                nu[group][name] = 0.999 * nu[group][name] + 0.001 * g * g
                p.sub_(lr * mu[group][name] / (torch.sqrt(nu[group][name]) + 1e-15))

    def _zero_head_moments(self):
        params = self.seg_head.params()
        return {part: {k: torch.zeros_like(v) for k, v in params.items()}
                for part in ("mu", "nu")}

    # ------------------------------------------------------------------
    def rasterize_splats(self, params, viewmats, Ks, width, height, sh_degree,
                         means2d_offset=None, means2d_abs_tap=None,
                         backgrounds=None, render_mode="RGB",
                         rasterizer: Optional[str] = None, override_features=None,
                         image_ids=None):
        """Render ``params`` to the cameras; ``rasterizer`` defaults to the
        config's (``"auto"`` is the differentiable ``"packed"``). With
        ``with_eval3d`` every render is ``"eval3d_packed"``, and the
        screen-space taps are dropped: that render never reads means2d.
        ``override_features`` [N, D] are rendered in place of the SH colours
        (the identity render), through the 3DGS rasterization for every
        model type. With ``app_opt`` the colours are the appearance
        module's per camera, sigmoid(MLP + ``colors``) [C, N, 3], with the
        view directions from the camera centres −Rᵀt and the embeddings of
        ``image_ids`` (None: zero embeddings, as eval renders)."""
        cfg = self.cfg
        means, quats, scales, opacities, sh = G.splat_activations(params)
        colors, sh_deg = sh, sh_degree
        if override_features is not None:
            colors, sh_deg = override_features, None
        elif self.app_module is not None:
            R, t = viewmats[..., :3, :3], viewmats[..., :3, 3]
            campos = -torch.einsum("...kj,...k->...j", R, t).reshape(-1, 3)
            dirs = means[None, :, :] - campos[:, None, :]  # [C, N, 3]
            colors = self.app_module(params["features"], image_ids, dirs, sh_degree)
            colors = torch.sigmoid(colors + params["colors"][None])
            sh_deg = None
        if rasterizer is None:
            rasterizer = "packed" if cfg.rasterizer == "auto" else cfg.rasterizer
        if cfg.model_type == "2dgs" and override_features is None:
            # eval and render only: the 2DGS train step renders in _loss_2dgs
            out = rasterization_2dgs(
                means, quats, scales, opacities, colors, viewmats, Ks, width, height,
                sh_degree=sh_deg, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                render_mode=render_mode, backgrounds=backgrounds,
                tile_capacity=cfg.tile_capacity, isect_capacity=cfg.isect_capacity,
                max_tiles_per_gauss=cfg.max_tiles_per_gauss, isect_exact=cfg.isect_exact,
                rasterizer=rasterizer, device=self.device,
            )
            return out[0], out[1], out[6]
        if cfg.with_eval3d:
            means2d_offset = means2d_abs_tap = None
        return rasterization(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            sh_degree=sh_deg, near_plane=cfg.near_plane, far_plane=cfg.far_plane,
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
    def train_step(self, batch: Dict[str, torch.Tensor], step: int, sh_degree: int,
                   use_seg: bool = False, use_spatial: bool = False,
                   seg_quality: bool = False):
        """One step: render, loss, gradients, selective Adam. Updates the
        splats and moments; returns (loss tensor, aux) with aux["radii"],
        aux["visibility"] and aux["v_means2d"] (None without the
        DefaultStrategy). ``use_seg``/``use_spatial`` add the segmentation
        step's CGC loss (``batch["instance_mask"]``) and spatial
        regularizer (see ``_seg_step``); the loss returned includes their
        terms, which aux["seg_terms"] holds, and with ``seg_quality``
        aux["cluster_quality"] the (intra, inter) of the first image.
        With the auxiliary modules the cameras of ``batch["image_id"]`` are
        perturbed and corrected before the render (``c2w = inv(viewmat)``,
        the fixed perturbation, the corrector, ``inv`` back), the render's
        RGB goes through the bilateral grids, the loss adds ``tvloss``,
        ``posereg`` and ``appreg`` (3DGS), and the aux Adam updates the
        modules."""
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
        seg_grads, seg_terms, cq = {}, {}, None
        if use_seg or use_spatial:
            seg_grads, seg_terms, cq = self._seg_step(params, batch, sh_degree, use_seg,
                                                      use_spatial, seg_quality)
        aux_groups = self.aux_params()
        image_ids = batch.get("image_id")
        if self._pose_perturb is not None or self.camera_opt is not None:
            # tdgs/training/trainer.py:625-642
            c2w = torch.linalg.inv(batch["viewmat"])
            if self._pose_perturb is not None:
                c2w = M.apply_camera_opt(self._pose_perturb, c2w, image_ids)
            if self.camera_opt is not None:
                c2w = self.camera_opt(c2w, image_ids)
            batch = dict(batch, viewmat=torch.linalg.inv(c2w))
        terms, depth = {}, None
        if cfg.model_type == "2dgs":
            loss, meta = self._loss_2dgs(params, batch, step, sh_degree, tap, abs_tap,
                                         backgrounds)
        else:
            render_mode = "RGB+ED" if (cfg.depth_loss or cfg.depth_normal_loss) else "RGB"
            img, _, meta = self.rasterize_splats(
                params, batch["viewmat"], batch["K"], W, H, sh_degree,
                means2d_offset=tap, means2d_abs_tap=abs_tap, backgrounds=backgrounds,
                render_mode=render_mode, image_ids=image_ids)
            if "mask" in batch:
                img = img * batch["mask"][..., None]
            rgb = img[..., :3]
            if self.bilagrid is not None:
                rgb = BG.bilateral_grid_slice(self.bilagrid, image_ids, rgb)
            terms["rgbloss"] = L.d_ssim_l1_loss(rgb, images, cfg.ssim_lambda)
            if self.bilagrid is not None:
                terms["tvloss"] = 10.0 * BG.total_variation_loss(self.bilagrid)
            if self.camera_opt is not None:
                terms["posereg"] = cfg.pose_opt_reg * M.camera_opt_reg(self.camera_opt.embeds)
            if self.app_module is not None:
                terms["appreg"] = cfg.app_opt_reg * (self.app_module.embeds ** 2).mean()
            for k, v in self._depth_normal_terms(params, batch, step, img, meta).items():
                terms[k] = v
            loss = sum(terms.values())
            if cfg.save_depth_normal_vis and img.shape[-1] > 3:
                depth = img[..., 3:].detach()
        if cfg.opacity_reg > 0:
            terms["opacityreg"] = cfg.opacity_reg * torch.sigmoid(params["opacities"]).abs().mean()
            loss = loss + terms["opacityreg"]
        if cfg.scale_reg > 0:
            terms["scalereg"] = cfg.scale_reg * torch.exp(params["scales"]).abs().mean()
            loss = loss + terms["scalereg"]

        names = list(params)
        aux_leaves = [(group, name, p) for group, ps in aux_groups.items()
                      for name, p in ps.items()]
        grads = torch.autograd.grad(
            loss, [params[k] for k in names] + taps + [p for _, _, p in aux_leaves],
            allow_unused=True)
        g_params = {k: (g if g is not None else torch.zeros_like(params[k]))
                    for k, g in zip(names, grads)}
        for k, g in seg_grads.items():
            # summed before the one Adam update: the fused loss's gradient
            g_params[k] = g_params[k] + g
        g_taps = grads[len(names):len(names) + len(taps)]
        g_aux = {group: {} for group in aux_groups}
        for (group, name, _), g in zip(aux_leaves, grads[len(names) + len(taps):]):
            g_aux[group][name] = g
        self._aux_update(g_aux)

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
        loss = loss.detach()
        for v in seg_terms.values():
            loss = loss + v
        return loss, {"radii": radii, "visibility": visibility,
                      "v_means2d": v_means2d, "lr_means": lr_dict["means"],
                      "n_dropped": meta["n_dropped"], "seg_terms": seg_terms,
                      "cluster_quality": cq, "depth": depth,
                      "loss_terms": {k: v.detach() for k, v in terms.items()}}

    def _depth_normal_terms(self, params, batch, step, img, meta):
        """The 3DGS step's depth and normal terms (``tdgs/training/
        trainer.py:782-858``) on the render ``img`` [B, H, W, 4] ("RGB+ED"),
        each weighted by its lambda: ``depthloss`` (dense against
        ``batch["depth_map"]``, else sparse at ``batch["points"]``),
        ``normalloss`` (the monocular normals, from
        ``start_normal_loss_step``) and ``depthsmooth`` with
        ``normalconsist`` (after ``depth_normal_start_step``). A term before
        its start step is left out: the JAX package multiplies it by 0."""
        cfg = self.cfg
        images = batch["image"]
        B = images.shape[0]
        terms = {}
        if cfg.depth_loss:
            if "depth_map" in batch:
                terms["depthloss"] = cfg.depth_lambda * L.depth_loss_dense(
                    img[..., 3:], batch["depth_map"], self.scene_scale)
            else:
                terms["depthloss"] = cfg.depth_lambda * L.depth_loss_sparse(
                    img[..., 3:], batch["points"], batch["depths"],
                    valid=batch.get("points_valid"))
        if cfg.load_normals and "normal" in batch and step >= cfg.start_normal_loss_step:
            # each gaussian's normal against the map at its projected centre,
            # over the gaussians the view sees; the sample's gradient
            # reaches the centres through meta["means2d"]
            g_norm, _ = NL.calculate_gaussian_splat_normal_differentiable(
                params["quats"], torch.exp(params["scales"]),
                torch.sigmoid(params["opacities"]))
            m2d = meta["means2d"].reshape(B, -1, 2)
            rad = meta["radii"].reshape(B, -1, 2)
            nl = sum(NL.masked_progressive_normal_loss(
                g_norm, NL.sample_normals_from_map(batch["normal"][b], m2d[b]),
                (rad[b] > 0).all(-1)) for b in range(B))
            terms["normalloss"] = cfg.mono_normal_lambda * nl / B
        if cfg.depth_normal_loss and step > cfg.depth_normal_start_step:
            # edge-aware depth smoothness and the total variation of the
            # depth map's normals
            depth = img[..., 3:]
            c2w = torch.linalg.inv(batch["viewmat"])
            sm = tv = 0.0
            for b in range(B):
                sm = sm + NL.depth_smoothness_loss(depth[b], images[b])
                dn = depth_to_normal(depth[b], c2w[b], batch["K"][b])
                tv = tv + NL.normal_total_variation(dn)
            terms["depthsmooth"] = cfg.lambda_depth_smooth * sm / B
            terms["normalconsist"] = cfg.lambda_normal_consistency * tv / B
        return terms

    def _seg_step(self, params, batch, sh_degree, use_seg, use_spatial, quality):
        """The segmentation losses on the pre-update ``params`` (port of
        ``tdgs/training/trainer.py:948 _seg_step_impl``): the head's
        features of the identity encodings rendered through the training
        rasterizer, the CGC loss per image (averaged, times
        ``seg_loss_weight``), and the spatial regularizer on a sample of
        the gaussians drawn from the runner's generator (times
        ``seg_spatial_weight``). Updates the head by its own Adam (lr 1e-3,
        β 0.9/0.999, no bias correction) and returns (the gradients of
        ``params``, the detached loss terms, the cluster quality of the
        first image or None)."""
        cfg = self.cfg
        head = self.seg_head.params()
        feats = seg_head_mod.apply_segmentation_head(head, params["identity_encodings"])
        terms, cq = {}, None
        if use_seg:
            B, H, W = batch["image"].shape[:3]
            fmap, _, _ = self.rasterize_splats(params, batch["viewmat"], batch["K"], W, H,
                                               sh_degree, override_features=feats)
            seg = sum(seg_losses.cgc_contrastive_clustering_loss(
                fmap[b], batch["instance_mask"][b], min_cluster_size=cfg.cgc_min_cluster)
                for b in range(B))
            terms["segloss"] = cfg.seg_loss_weight * seg / B
            if quality:
                cq = seg_losses.cluster_quality(fmap[0].detach(), batch["instance_mask"][0])
        if use_spatial:
            terms["spatialreg"] = cfg.seg_spatial_weight * seg_losses.cgc_spatial_regularizer(
                feats, params["means"], self.generator, k_near=cfg.cgc_k_near,
                k_far=cfg.cgc_k_far, lambda_near=cfg.cgc_lambda_near,
                lambda_far=cfg.cgc_lambda_far)
        names = list(params)
        head_names = list(head)
        grads = torch.autograd.grad(sum(terms.values()),
                                    [params[k] for k in names] + [head[k] for k in head_names],
                                    allow_unused=True)
        g_params = {k: g for k, g in zip(names, grads) if g is not None}
        with torch.no_grad():
            mu, nu = self.seg_opt_state["mu"], self.seg_opt_state["nu"]
            for k, g in zip(head_names, grads[len(names):]):
                if g is None:
                    g = torch.zeros_like(head[k])
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                head[k].sub_(1e-3 * mu[k] / (torch.sqrt(nu[k]) + 1e-15))
        return g_params, {k: v.detach() for k, v in terms.items()}, cq

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
        # the training set's indices: the rows of the per-image modules
        batch["image_id"] = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
        if all("mask" in it for it in items):
            batch["mask"] = torch.as_tensor(np.stack([it["mask"] for it in items]),
                                            dtype=torch.float32, device=dev)
        if all("instance_mask" in it for it in items):
            batch["instance_mask"] = torch.as_tensor(
                np.stack([it["instance_mask"] for it in items]).astype(np.int64), device=dev)
        cfg = self.cfg
        if cfg.load_normals and all("normal" in it for it in items):
            batch["normal"] = torch.as_tensor(np.stack([it["normal"] for it in items]),
                                              dtype=torch.float32, device=dev)
        if cfg.depth_loss:
            if cfg.use_precomputed_depths and all("refined_depth" in it for it in items):
                batch["depth_map"] = torch.as_tensor(
                    np.stack([it["refined_depth"] for it in items]), dtype=torch.float32,
                    device=dev)
            else:
                batch.update({k: torch.as_tensor(v, device=dev)
                              for k, v in self._depth_fields(items).items()})
        return batch

    @staticmethod
    def _depth_fields(items) -> Dict[str, np.ndarray]:
        """Each image's sparse depth points padded to the batch's longest
        list (at least 1): ``points`` [B, M, 2], ``depths`` [B, M] and
        ``points_valid`` [B, M] (1 on real points)."""
        m = max(len(it.get("points", [])) for it in items) or 1
        pts = np.zeros((len(items), m, 2), np.float32)
        dep = np.zeros((len(items), m), np.float32)
        val = np.zeros((len(items), m), np.float32)
        for i, it in enumerate(items):
            k = len(it.get("points", []))
            if k:
                pts[i, :k] = it["points"]
                dep[i, :k] = it["depths"]
                val[i, :k] = 1.0
        return {"points": pts, "depths": dep, "points_valid": val}

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
            # decode-ahead: the next steps' images decode while this one runs
            self.trainset.prefetch(order[cursor:cursor + 4 * cfg.batch_size])
            batch = self._batch(idx)
            H, W = batch["image"].shape[1:3]
            sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            # the segmentation cadence (tdgs/training/trainer.py:1100-1114)
            seg_live = cfg.with_segmentation and step >= cfg.seg_start_iter
            use_seg = (seg_live and step % cfg.seg_loss_every == 0
                       and "instance_mask" in batch)
            use_spatial = seg_live and step % cfg.seg_spatial_every == 0
            log_step = step % cfg.tb_every == 0 or step == cfg.max_steps
            loss, aux = self.train_step(batch, step, sh_degree, use_seg=use_seg,
                                        use_spatial=use_spatial, seg_quality=log_step)
            self.seg_steps += int(use_seg or use_spatial)

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

            if log_step:
                history.append({"step": step, "loss": float(loss)})
                scalars = {
                    "train/loss": float(loss),
                    "train/num_GS": int(G.alive_mask(self.splats).sum()),
                    "train/visible_GS": int(aux["visibility"].sum()),
                    "train/sh_degree": sh_degree,
                }
                scalars.update({f"train/{k}": float(v) for k, v in aux["loss_terms"].items()})
                scalars.update({f"train/{k}": float(v) for k, v in aux["seg_terms"].items()})
                if aux["cluster_quality"] is not None:
                    intra, inter = aux["cluster_quality"]
                    scalars["train/cluster_intra"] = float(intra)
                    scalars["train/cluster_inter"] = float(inter)
                self.logger.log(step, scalars)
                if cfg.save_depth_normal_vis and aux["depth"] is not None:
                    self._save_depth_normal_vis(step, aux["depth"][0], batch)
            if step in cfg.eval_steps:
                self.eval(step)
            if step in cfg.save_steps:
                self.save_checkpoint(step)
            if cfg.save_ply and step in cfg.ply_steps:
                self.export_ply(step)
        return {"history": history, "wall_time_s": time.time() - t0}

    @torch.no_grad()
    def _save_depth_normal_vis(self, step: int, depth: torch.Tensor, batch) -> None:
        """vis/depth_{step}.png (turbo colours) and vis/normal_{step}.png
        (the depth map's world normals as (n + 1)/2) of the batch's first
        image; ``depth`` [H, W, 1]."""
        from tdgs_torch.utils.viz import apply_depth_colormap, save_image

        vis_dir = os.path.join(self.cfg.result_dir, "vis")
        save_image(apply_depth_colormap(depth.cpu().numpy()),
                   os.path.join(vis_dir, f"depth_{step:05d}.png"))
        n = depth_to_normal(depth, torch.linalg.inv(batch["viewmat"][0]), batch["K"][0])
        save_image(((n + 1.0) / 2.0).cpu().numpy(),
                   os.path.join(vis_dir, f"normal_{step:05d}.png"))

    def close(self) -> None:
        """Stop the training set's decode-ahead threads."""
        self.trainset.close()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval(self, step: int, stage: str = "val") -> Dict[str, Any]:
        """PSNR, SSIM and LPIPS over the test views, rendered by the
        forward-only ``packed_inference`` rasterizer (the appearance
        module's colours with zero embeddings); writes
        stats/{stage}_step{step}.json. LPIPS is learned with local weights
        (key ``lpips``), else the random-filter proxy (``lpips_proxy``, not
        comparable to learned values); ``lpips_impl`` names it. With the
        bilateral grids also ``cc_psnr``, ``cc_ssim`` and ``cc_`` + the
        LPIPS key, scored after the least-squares colour correction
        (``bilateral_grid.color_correct``)."""
        cfg = self.cfg
        metrics = defaultdict(list)
        impl = lpips_impl(cfg.lpips_net)
        lpips_key = "lpips" if impl.startswith("learned") else "lpips_proxy"
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
            metrics[lpips_key].append(float(lpips(pred[None], gt[None], net=cfg.lpips_net)[0]))
            if cfg.use_bilateral_grid:
                cc = BG.color_correct(pred, gt)
                metrics["cc_psnr"].append(float(L.psnr(cc, gt)))
                metrics["cc_ssim"].append(float(L.ssim(cc[None], gt[None])))
                metrics[f"cc_{lpips_key}"].append(
                    float(lpips(cc[None], gt[None], net=cfg.lpips_net)[0]))
            if cfg.tb_save_image:
                from tdgs_torch.utils.png import write_png

                both = torch.cat([gt, pred], dim=1).cpu().numpy()
                write_png(os.path.join(self.stats_dir, f"{stage}_step{step}_{i:04d}.png"),
                          (np.clip(both, 0, 1) * 255).astype(np.uint8))
        out = {k: float(np.mean(v)) for k, v in metrics.items()}
        out["lpips_impl"] = impl
        if lpips_key == "lpips_proxy":
            out["lpips_note"] = ("no LPIPS weights on disk: lpips_proxy is a fixed-seed "
                                 "random-filter perceptual distance, not comparable to "
                                 "learned LPIPS values")
        out["ellipse_time"] = (time.time() - t0) / max(len(self.valset), 1)
        out["num_GS"] = int(G.alive_mask(self.splats).sum())
        with open(os.path.join(self.stats_dir, f"{stage}_step{step}.json"), "w") as f:
            json.dump(out, f)
        self.logger.log(step, {f"{stage}/{k}": v for k, v in out.items()})
        return out

    def render_traj(self, step: int, n_frames: int = 60, traj_path: str = "interp") -> str:
        """Render a camera path (``traj_frames``) and write it:
        ``traj_{step}.gif`` where PIL imports, else the frames as
        ``traj_{step}/frame_{i:04d}.png``. Returns that path."""
        return self.write_traj(step, self.traj_frames(n_frames, traj_path))

    @torch.no_grad()
    def traj_frames(self, n_frames: int = 60, traj_path: str = "interp"):
        """The uint8 RGB frames [H, W, 3] of a camera path ("interp": a
        spline through every sixth training camera; "ellipse"; "spiral")
        rendered in "RGB+ED" through the forward-only ``packed_inference``
        rasterizer."""
        from tdgs_torch.datasets import traj as T

        c2w = self.parser.camtoworlds[:, :3, :]
        if traj_path == "ellipse":
            path = T.generate_ellipse_path_z(c2w, n_frames=n_frames)
        elif traj_path == "spiral":
            path = T.generate_spiral_path(c2w, n_frames=n_frames)
        else:
            keyframes = c2w[::max(len(c2w) // 6, 1)]
            path = T.generate_interpolated_path(
                keyframes, n_interp=max(n_frames // max(len(keyframes) - 1, 1), 1))
        cam = self.parser.camera_ids[0]
        K = torch.as_tensor(self.parser.Ks_dict[cam], dtype=torch.float32,
                            device=self.device)[None]
        W, H = self.parser.imsize_dict[cam]
        frames = []
        for c in path:
            c2w4 = np.eye(4, dtype=np.float32)
            c2w4[:3] = c
            viewmat = torch.as_tensor(np.linalg.inv(c2w4).astype(np.float32),
                                      device=self.device)[None]
            img, _, _ = self.rasterize_splats(self.splats, viewmat, K, W, H,
                                              self.cfg.sh_degree, render_mode="RGB+ED",
                                              rasterizer="packed_inference")
            frames.append((torch.clamp(img[0, ..., :3], 0, 1) * 255).to(torch.uint8))
        return [f.cpu().numpy() for f in frames]

    def write_traj(self, step: int, frames) -> str:
        """``traj_{step}.gif`` of the frames where PIL imports, else
        ``traj_{step}/frame_{i:04d}.png``; returns the path."""
        try:
            from PIL import Image
        except ImportError:
            from tdgs_torch.utils.png import write_png

            out = os.path.join(self.cfg.result_dir, f"traj_{step}")
            os.makedirs(out, exist_ok=True)
            for i, f in enumerate(frames):
                write_png(os.path.join(out, f"frame_{i:04d}.png"), f)
            return out
        out = os.path.join(self.cfg.result_dir, f"traj_{step}.gif")
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(out, save_all=True, append_images=imgs[1:], duration=33, loop=0)
        return out

    # ------------------------------------------------------------------
    def state_numpy(self, step: int) -> Dict[str, Any]:
        """The checkpoint's content: the JAX package's keys, holding only
        builtins and numpy arrays."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

        state = {
            "step": int(step),
            "splats": tree_map(host, self.splats),
            "opt_state": tree_map(host, self.opt_state),
            "strategy_state": tree_map(host, dict(self.strategy_state)),
        }
        if self.seg_head is not None:
            state["segmentation_head"] = seg_head_mod.head_to_numpy(self.seg_head)
        return state

    def save_checkpoint(self, step: int) -> str:
        """Pickle of step, splats, Adam moments and strategy state."""
        path = os.path.join(self.ckpt_dir, f"ckpt_{step}.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.state_numpy(step), f)
        return path

    def load_state_numpy(self, state: Dict[str, Any]) -> int:
        """Restore from the checkpoint's content (see ``state_numpy``). A
        ``segmentation_head`` replaces the head; its Adam moments restart
        at zero, as the JAX package's checkpoints do not hold them."""
        def dev(x):
            return torch.as_tensor(x, device=self.device) if isinstance(x, np.ndarray) else x

        self.splats = tree_map(dev, state["splats"])
        self.capacity = self.splats["means"].shape[0]
        self.opt_state = tree_map(dev, state["opt_state"])
        self.strategy_state.update(tree_map(dev, state["strategy_state"]))
        if "segmentation_head" in state:
            self.seg_head = seg_head_mod.head_from_numpy(state["segmentation_head"],
                                                         device=self.device)
            self.seg_opt_state = self._zero_head_moments()
        return int(state["step"])

    def load_checkpoint(self, path: str) -> int:
        with open(path, "rb") as f:
            return self.load_state_numpy(pickle.load(f))

    @torch.no_grad()
    def render_identity_map(self, view_index: int = 0) -> np.ndarray:
        """The head's features of the identity encodings rendered to one
        training view by the forward-only ``packed_inference`` rasterizer →
        [H, W, identity_dim] numpy."""
        if self.seg_head is None:
            raise ValueError("segmentation is not enabled (Config.with_segmentation)")
        d = self.trainset[view_index]
        H, W = d["image"].shape[:2]
        feats = seg_head_mod.apply_segmentation_head(self.seg_head,
                                                     self.splats["identity_encodings"])
        fmap, _, _ = self.rasterize_splats(
            self.splats, torch.as_tensor(d["viewmat"], device=self.device)[None],
            torch.as_tensor(d["K"], device=self.device)[None], W, H, self.cfg.sh_degree,
            rasterizer="packed_inference", override_features=feats)
        return fmap[0].cpu().numpy()

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

    def run_compression(self, step: int) -> Dict[str, Any]:
        """Compress the alive splats (``compression.PngCompression``, its
        K-means on the runner's device) into result_dir/compression,
        decompress them and eval the round trip as stage ``compress``
        (stats/compress_step{step}.json); the splats are left as they
        were."""
        from tdgs_torch.compression import PngCompression

        compress_dir = os.path.join(self.cfg.result_dir, "compression")
        keep = G.alive_mask(self.splats)
        method = PngCompression(device=self.device)
        method.compress(compress_dir, {k: v[keep].detach().cpu().numpy()
                                       for k, v in self.splats.items()})
        orig = self.splats
        try:
            self.splats = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                           for k, v in method.decompress(compress_dir).items()}
            return self.eval(step, stage="compress")
        finally:
            self.splats = orig

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
