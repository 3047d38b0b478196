"""Single-device 3DGS and 2DGS trainer (port of
``tdgs/training/trainer.py``: ``make_lr_schedules`` :33, ``SplatOptimizer``
:56 and the single-device paths of ``Runner`` :97).

One training step: splat activations → ``rasterization(rasterizer=
"packed")`` with the screen-space taps (projection, SH, tile sort, then the
forward kernel; backward kernel and segment-sum kernel under autograd; or,
with ``Config.rasterizer`` "pallas", the dense tiling and kernels 9 and 10,
or "jax", their plain tensor form) →
(1−λ)·L1 + λ·(1−SSIM) → gradients → selective Adam without bias correction
(on the card one launch of ``csrc/adam.cu`` over every group) →
DefaultStrategy accumulation and refine. With ``model_type="2dgs"`` the
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
come from one ``torch.Generator``.
With ``Config.sharded`` the runner is one rank of a ``torch.distributed``
world (``parallel.launch``, or ``python -m torch.distributed.run
--nproc-per-node W -m tdgs_torch.simple_trainer ... --sharded``): it holds
its block of ``capacity / W`` gaussian rows (splats, Adam moments, strategy
rows) and its ``batch_size / W`` cameras of each step's batch, and renders
through ``parallel.sharded_render`` (the JAX ``Runner``'s mesh path,
``tdgs/training/trainer.py:148-178``, :465-500, :654-663). Every rank makes
the same global init, draws and batch order from the same seeds. Each loss
term is this rank's share of the global mean; per-gaussian gradients reach
their owners through the exchange, and the replicated modules' gradients
(pose corrector, appearance module, bilateral grids, segmentation head) are
summed over the ranks. Refines, resets and capacity growth run on the rows
gathered whole, exactly as on one device, and each rank keeps its block;
eval, the trajectory and the identity map render the gathered splats.
Files are written by rank 0; the sharded checkpoint
(``ckpt_format="orbax"``, ``parallel/checkpoint.py``) by every rank. Which
arrays are rows is ``parallel/rows.py``'s rule. With ``data_prefetch`` the
training images decode on a thread pool a few steps ahead. Eval renders the test
views through the forward-only ``packed_inference`` rasterizer (kernel 7's
forward-only call under eval3d) and reports PSNR, SSIM and LPIPS (learned
with local weights, else the random-filter proxy, ``lpips_proxy``);
``render_traj`` renders a camera path through it.
"""

from __future__ import annotations

import functools
import json
import math
import os
import pickle
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.datasets import Dataset, Parser
from tdgs_torch.models import gaussians as G
from tdgs_torch.ops.adam import adam_update
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut
from tdgs_torch.parallel import comm, rows
from tdgs_torch.parallel.mesh import initialize_multihost, make_mesh
from tdgs_torch.parallel.sharded_render import (
    rasterization_2dgs_sharded,
    rasterization_eval3d_sharded,
    rasterization_sharded,
)
from tdgs_torch.rendering import rasterization, rasterization_2dgs
from tdgs_torch.segmentation import head as seg_head_mod
from tdgs_torch.segmentation import losses as seg_losses
from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy
from tdgs_torch.strategy.ops import inject_noise_to_position, pad_rows, tree_map
from tdgs_torch.training import bilateral_grid as BG
from tdgs_torch.training import losses as L
from tdgs_torch.training import modules as M
from tdgs_torch.training import normal_losses as NL
from tdgs_torch.training.config import Config
from tdgs_torch.training.metrics import lpips, lpips_impl
from tdgs_torch.utils.depth import depth_to_normal, rotate
from tdgs_torch.utils.logger import MetricsLogger, device_mem_gb
from tdgs_torch.utils.profiler import host_read, span
from tdgs_torch.viewer.server import frame_to_uint8, viewer_rasterizer


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
        ``visibility`` keep their value and moments. On the card one launch
        of the Adam kernel updates every group."""
        new_params, new_mu, new_nu = adam_update(params, grads, state["mu"], state["nu"],
                                                 lr_dict, self.b1, self.b2, self.eps,
                                                 visibility)
        return new_params, {"mu": new_mu, "nu": new_nu}


def _under_viewer_lock(method):
    """Run a ``Runner`` method under its ``viewer_lock`` (reentrant): the
    live viewer's render never reads a state the method is writing."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self.viewer_lock:
            return method(self, *args, **kwargs)
    return locked


class Runner:
    """Training runner for 3DGS (screen-space or 3DGUT) or 2DGS, with the
    DefaultStrategy or the MCMCStrategy, on one device or (``Config.sharded``)
    as one rank of a gaussian-sharded world."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        cfg = cfg.adjusted()
        cfg.check_ported()
        self.cfg = cfg
        # every write to the splats, the moments and the aux modules, and the
        # live viewer's render, hold this lock (tdgs/training/trainer.py:274)
        self.viewer_lock = threading.RLock()
        self.viewer = None
        # Config.sharded: this process is one rank (tdgs/training/trainer.py:148-178)
        self.mesh = None
        self._owns_world = False
        if cfg.sharded:
            self._owns_world = not torch.distributed.is_initialized()
            initialize_multihost(device)
            self.mesh = make_mesh(device=device)
            if cfg.batch_size % self.mesh.world:
                raise ValueError(f"sharded: batch_size {cfg.batch_size} must divide over "
                                 f"{self.mesh.world} ranks (each renders batch/W cameras)")
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        os.makedirs(cfg.result_dir, exist_ok=True)
        self.stats_dir = os.path.join(cfg.result_dir, "stats")
        self.ckpt_dir = os.path.join(cfg.result_dir, "ckpts")
        os.makedirs(self.stats_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger = MetricsLogger(cfg.result_dir) if self.is_main else None

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
        # the live viewer's splats under sharding: rank 0's last gathered copy
        self._viewer_copy = self.splats if self.mesh is not None and self.is_main else None
        self._viewer_wanted = False
        if self.mesh is not None:
            # every rank made the same global state: keep this rank's block
            if self.capacity % self.mesh.world:
                raise ValueError(f"sharded: capacity {self.capacity} must divide over "
                                 f"{self.mesh.world} ranks")
            self._set_trees(self._shard(self._trees()))
        if not cfg.disable_viewer and self.is_main:
            from tdgs_torch.viewer import ViewerServer

            center = self.parser.camtoworlds[:, :3, 3].mean(axis=0)
            self.viewer = ViewerServer(self._viewer_render_fn, port=cfg.viewer_port,
                                       target=center)
            self.viewer.start()
            print(f"live viewer at http://localhost:{self.viewer.port}", flush=True)

    # ------------------------------------------------------------------
    # Config.sharded: each rank holds a block of the gaussian rows
    def _trees(self) -> Dict[str, Any]:
        """The state that holds per-gaussian rows, under the checkpoint's
        keys (``parallel.rows.TREES``)."""
        return {"splats": self.splats, "opt_state": self.opt_state,
                "strategy_state": self.strategy_state}

    def _set_trees(self, trees: Dict[str, Any]) -> None:
        self.splats, self.opt_state, self.strategy_state = (trees[k] for k in rows.TREES)

    def _shard(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's block of every per-gaussian array of ``state`` (the
        JAX ``Runner._shard_gauss``, :310; ``parallel.rows``); the rest
        whole."""
        n = self.capacity // self.mesh.world
        lo = self.mesh.rank * n

        def cut(x):
            if x.shape[0] != self.capacity:
                raise ValueError(f"{x.shape[0]} rows, not the capacity {self.capacity}")
            return x[lo:lo + n].clone()

        return rows.map_rows(cut, state)

    @torch.no_grad()
    def _gather(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Every per-gaussian array of ``state``, held in blocks of rows,
        whole again; a collective call on every rank."""
        return rows.map_rows(comm.all_gather, state)

    def _blocked(self, params) -> bool:
        """Do ``params`` hold this rank's block (a sharded render), rather
        than every row?"""
        return self.mesh is not None and params["means"].shape[0] != self.capacity

    def _replicated_splats(self) -> G.SplatParams:
        """The splats whole on every rank (the JAX ``Runner.
        _replicated_splats``, :330), for the renders of single cameras:
        eval, the trajectory, the identity map. Collective under sharding."""
        if not self._blocked(self.splats):
            return self.splats
        return self._gather({"splats": self.splats})["splats"]

    def _world_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (itself on one device), detached."""
        x = x.detach()
        return comm.all_reduce_sum(x) if self.mesh is not None else x

    def _alive_count(self, site: str = "alive_count") -> int:
        return host_read(self._world_sum(G.alive_mask(self.splats).sum()), site, int)

    # ------------------------------------------------------------------
    # the live viewer (tdgs/training/trainer.py:526-600)
    def _inference_rasterizer(self) -> str:
        """The forward-only rasterizer of the live view: kernel 1, 4 or 7
        on the card, their plain tensor routes on the CPU."""
        model = "3dgut" if self.cfg.with_eval3d else self.cfg.model_type
        return viewer_rasterizer(model, self.device)

    def _viewer_splats(self) -> G.SplatParams:
        """The splats the live view renders: the runner's own, or under
        sharding rank 0's copy from the last step boundary at which every
        rank joined the gather (``_sync_viewer_copy``). A viewer thread
        never calls a collective: alone on rank 0 it would hang the world."""
        if self.mesh is None:
            return self.splats
        self._viewer_wanted = True
        return self._viewer_copy

    def _sync_viewer_copy(self) -> None:
        """Under sharding with the viewer on, at a step boundary on every
        rank: one all-reduce of rank 0's flag "a frame was asked for since
        the last copy", and if it is set, the splats gathered whole on every
        rank, kept by rank 0 for the viewer."""
        wanted = torch.tensor([1.0 if self._viewer_wanted else 0.0], device=self.device)
        if float(comm.all_reduce_sum(wanted)) == 0.0:
            return
        whole = self._gather({"splats": self.splats})["splats"]
        if self.is_main:
            with self.viewer_lock:
                self._viewer_copy = whole
                self._viewer_wanted = False

    @torch.no_grad()
    def _viewer_render_fn(self, viewmat, K, width, height, st):
        """The live view for ``ViewerServer``: the current splats rendered
        under the lock with the render tab's knobs. "depth" renders "ED"
        (2DGS: "RGB+ED", its last channel), scaled by its 2nd and 98th
        percentiles and inverted with ``inverse_depth``; the background is
        passed in "rgb" only; ``with_eval3d`` renders through eval3d."""
        cfg = self.cfg
        mode = {"rgb": "RGB", "depth": "ED", "alpha": "RGB"}[st.render_mode]
        with self.viewer_lock:
            means, quats, scales, opacities, sh = G.splat_activations(self._viewer_splats())
            dev = means.device
            bkgd = (torch.tensor(st.backgrounds, dtype=torch.float32, device=dev)[None]
                    if st.render_mode == "rgb" else None)
            cams = (torch.as_tensor(viewmat, dtype=torch.float32, device=dev)[None],
                    torch.as_tensor(K, dtype=torch.float32, device=dev)[None], width, height)
            common = dict(sh_degree=min(st.max_sh_degree, cfg.sh_degree),
                          near_plane=st.near_plane, far_plane=st.far_plane,
                          radius_clip=st.radius_clip, backgrounds=bkgd,
                          tile_capacity=cfg.tile_capacity, isect_capacity=cfg.isect_capacity,
                          rasterizer=self._inference_rasterizer(), device=dev)
            if cfg.model_type == "2dgs":
                out = rasterization_2dgs(means, quats, scales, opacities, sh, *cams,
                                         render_mode="RGB+ED" if mode == "ED" else mode,
                                         **common)
                img, alpha = out[0], out[1]
            else:
                img, alpha, _ = rasterization(means, quats, scales, opacities, sh, *cams,
                                              eps2d=st.eps2d, render_mode=mode,
                                              with_eval3d=cfg.with_eval3d, with_ut=cfg.with_ut,
                                              **common)
            return frame_to_uint8(img, alpha, st.render_mode, st.inverse_depth)

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

    @_under_viewer_lock
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
        ``image_ids`` (None: zero embeddings, as eval renders).
        ``params`` holding this rank's block of the rows (``Config.sharded``)
        render this rank's cameras through ``parallel.sharded_render``
        (3DGS and eval3d; 2DGS trains through ``_loss_2dgs``); the
        appearance colours are then those of every camera of the batch
        against the block, and the taps [batch, block, 2]."""
        cfg = self.cfg
        blocked = self._blocked(params)
        means, quats, scales, opacities, sh = G.splat_activations(params)
        colors, sh_deg = sh, sh_degree
        if override_features is not None:
            colors, sh_deg = override_features, None
        elif self.app_module is not None:
            if blocked:
                # the colours of every camera of the batch, for this block
                viewmats_all = comm.all_gather(viewmats)
                image_ids = comm.all_gather(image_ids)
            else:
                viewmats_all = viewmats
            R, t = viewmats_all[..., :3, :3], viewmats_all[..., :3, 3]
            campos = -torch.einsum("...kj,...k->...j", R, t).reshape(-1, 3)
            dirs = means[None, :, :] - campos[:, None, :]  # [C, N, 3]
            colors = self.app_module(params["features"], image_ids, dirs, sh_degree)
            colors = torch.sigmoid(colors + params["colors"][None])
            sh_deg = None
        if rasterizer is None:
            rasterizer = "packed" if cfg.rasterizer == "auto" else cfg.rasterizer
        if blocked:
            common = dict(sh_degree=sh_deg, near_plane=cfg.near_plane,
                          far_plane=cfg.far_plane, tile_capacity=cfg.tile_capacity,
                          isect_capacity=cfg.isect_capacity,
                          max_tiles_per_gauss=cfg.max_tiles_per_gauss,
                          backgrounds=backgrounds, camera_model=cfg.camera_model,
                          render_mode=render_mode)
            if cfg.with_eval3d:
                return rasterization_eval3d_sharded(
                    means, quats, scales, opacities, colors, viewmats, Ks, width, height,
                    self.mesh, with_ut=cfg.with_ut, **common)
            return rasterization_sharded(
                means, quats, scales, opacities, colors, viewmats, Ks, width, height,
                self.mesh, rasterize_mode="antialiased" if cfg.antialiased else "classic",
                rasterizer=rasterizer, means2d_offset=means2d_offset,
                means2d_abs_tap=means2d_abs_tap, **common)
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
    @_under_viewer_lock
    def train_step(self, batch: Dict[str, torch.Tensor], step: int, sh_degree: int,
                   use_seg: bool = False, use_spatial: bool = False,
                   seg_quality: bool = False):
        """One step: render, loss, gradients, selective Adam. Updates the
        splats and moments; returns (loss tensor, aux) with aux["radii"],
        aux["visibility"] and aux["v_means2d"] (None without the
        DefaultStrategy, or past its stop: ``reads_grads``).
        ``use_seg``/``use_spatial`` add the segmentation
        step's CGC loss (``batch["instance_mask"]``) and spatial
        regularizer (see ``_seg_step``); the loss returned includes their
        terms, which aux["seg_terms"] holds, and with ``seg_quality``
        aux["cluster_quality"] the (intra, inter) of the first image.
        With the auxiliary modules the cameras of ``batch["image_id"]`` are
        perturbed and corrected before the render (``c2w = inv(viewmat)``,
        the fixed perturbation, the corrector, ``inv`` back), the render's
        RGB goes through the bilateral grids, the loss adds ``tvloss``,
        ``posereg`` and ``appreg`` (3DGS), and the aux Adam updates the
        modules.
        Under ``Config.sharded`` the batch holds this rank's cameras, the
        loss is this rank's share of the global mean (the returned loss and
        terms are summed over the ranks), the taps are [global batch,
        block, 2] and aux["visibility"] covers the block."""
        cfg = self.cfg
        images = batch["image"]
        B, H, W = images.shape[:3]
        dev = self.device
        blocked = self._blocked(self.splats)
        world = self.mesh.world if blocked else 1
        # this rank's cameras of the global batch
        cams = slice(self.mesh.rank * B, (self.mesh.rank + 1) * B) if blocked else slice(0, B)
        if cfg.random_bkgd:
            # every rank draws the whole batch's: the generators stay in step
            backgrounds = torch.rand((B * world, 3), generator=self.generator,
                                     device=dev)[cams]
        elif cfg.background_color is not None:
            backgrounds = torch.tensor(cfg.background_color, dtype=torch.float32,
                                       device=dev).expand(B, 3)
        else:
            backgrounds = None
        # eval3d renders give no screen-space gradients (means2d only tiles);
        # past its stop the strategy reads none
        use_tap = (isinstance(self.strategy, DefaultStrategy) and not cfg.with_eval3d
                   and self.strategy.reads_grads(step))
        use_absgrad = use_tap and self.strategy.absgrad

        params = {k: v.detach().requires_grad_(True) for k, v in self.splats.items()}
        n_rows = params["means"].shape[0]
        taps = []
        tap = abs_tap = None
        if use_tap:
            tap = torch.zeros((B * world, n_rows, 2), device=dev, requires_grad=True)
            taps.append(tap)
        if use_absgrad:
            abs_tap = torch.zeros((B * world, n_rows, 2), device=dev, requires_grad=True)
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
            with span("render"):
                img, _, meta = self.rasterize_splats(
                    params, batch["viewmat"], batch["K"], W, H, sh_degree,
                    means2d_offset=tap, means2d_abs_tap=abs_tap, backgrounds=backgrounds,
                    render_mode=render_mode, image_ids=image_ids)
        with span("loss"):
            if cfg.model_type != "2dgs":
                if "mask" in batch:
                    img = img * batch["mask"][..., None]
                rgb = img[..., :3]
                if self.bilagrid is not None:
                    rgb = BG.bilateral_grid_slice(self.bilagrid, image_ids, rgb)
                terms["rgbloss"] = L.d_ssim_l1_loss(rgb, images, cfg.ssim_lambda)
                if self.bilagrid is not None:
                    terms["tvloss"] = 10.0 * BG.total_variation_loss(self.bilagrid)
                if self.camera_opt is not None:
                    terms["posereg"] = cfg.pose_opt_reg * M.camera_opt_reg(
                        self.camera_opt.embeds)
                if self.app_module is not None:
                    terms["appreg"] = cfg.app_opt_reg * (self.app_module.embeds ** 2).mean()
                for k, v in self._depth_normal_terms(params, batch, step, img, meta).items():
                    terms[k] = v
                if cfg.save_depth_normal_vis and img.shape[-1] > 3:
                    depth = img[..., 3:].detach()
            # every term above is a mean over the batch's images (or of the
            # replicated modules): this rank's share of it is 1/W
            terms = {k: v / world for k, v in terms.items()}
            if cfg.model_type == "2dgs":
                loss = loss / world
            else:
                loss = sum(terms.values())
            if cfg.opacity_reg > 0:
                terms["opacityreg"] = cfg.opacity_reg * self._row_mean(
                    torch.sigmoid(params["opacities"]).abs())
                loss = loss + terms["opacityreg"]
            if cfg.scale_reg > 0:
                terms["scalereg"] = cfg.scale_reg * self._row_mean(
                    torch.exp(params["scales"]).abs())
                loss = loss + terms["scalereg"]

        with span("backward"):
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
            for (group, name, p), g in zip(aux_leaves, grads[len(names) + len(taps):]):
                if blocked:
                    # replicated modules: the gradient of the global loss
                    g = self._world_sum(torch.zeros_like(p) if g is None else g)
                g_aux[group][name] = g
            self._aux_update(g_aux)

        with span("adam"):
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
        if blocked:
            # the global loss and terms: every rank's share summed
            named = [("loss", loss)] + [(("t", k), v) for k, v in terms.items()] + [
                (("s", k), v) for k, v in seg_terms.items()]
            summed = self._world_sum(torch.stack([v.detach().reshape(()) for _, v in named]))
            got = dict(zip([k for k, _ in named], summed))
            loss = got["loss"]
            terms = {k: got[("t", k)] for k in terms}
            seg_terms = {k: got[("s", k)] for k in seg_terms}
        return loss, {"radii": radii, "visibility": visibility,
                      "v_means2d": v_means2d, "lr_means": lr_dict["means"],
                      "n_dropped": meta["n_dropped"], "seg_terms": seg_terms,
                      "cluster_quality": cq, "depth": depth,
                      "loss_terms": {k: v.detach() for k, v in terms.items()}}

    def _row_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every gaussian row of ``x`` [rows, ...]: under
        sharding this rank's share of it (its block's sum over the whole
        capacity's count)."""
        if self.mesh is None or x.shape[0] == self.capacity:
            return x.mean()
        return x.sum() / (x.numel() * self.mesh.world)

    def _masked_mean_share(self, value: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """A masked mean over this rank's images (``value``, normalised by
        ``max(count, 1)``) → its share of the masked mean over the global
        batch, times the world: the caller's 1/W share applies after."""
        if self.mesh is None:
            return value
        count = count.detach().to(value.dtype)
        total = self._world_sum(count)
        return value * torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0) * self.mesh.world

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
            # masked means: under sharding each rank's share of the global one
            if "depth_map" in batch:
                count = ((batch["depth_map"] > 0.0) & (img[..., 3] > 0.0)).sum()
                terms["depthloss"] = cfg.depth_lambda * self._masked_mean_share(
                    L.depth_loss_dense(img[..., 3:], batch["depth_map"], self.scene_scale),
                    count)
            else:
                valid = batch.get("points_valid")
                terms["depthloss"] = cfg.depth_lambda * self._masked_mean_share(
                    L.depth_loss_sparse(img[..., 3:], batch["points"], batch["depths"],
                                        valid=valid),
                    valid.sum() if valid is not None else torch.ones((), device=img.device))
        if cfg.load_normals and "normal" in batch and step >= cfg.start_normal_loss_step:
            # each gaussian's normal against the map at its projected centre,
            # over the gaussians the view sees; the sample's gradient
            # reaches the centres through meta["means2d"]
            g_norm, _ = NL.calculate_gaussian_splat_normal_differentiable(
                params["quats"], torch.exp(params["scales"]),
                torch.sigmoid(params["opacities"]))
            normal_maps, m2d, rad = batch["normal"], meta["means2d"], meta["radii"]
            if not m2d.requires_grad:
                # the eval3d render's UT projection only tiled: the centres
                # again through the differentiable chain
                m2d, rad = self._ut_centres(params, batch, img.shape[2], img.shape[1])
            if self._blocked(params):
                # the loss over every view and gaussian, alike on each rank:
                # the maps, the normals and the centres gathered whole
                normal_maps = comm.all_gather(normal_maps.detach())
                g_norm = comm.all_gather(g_norm)
                m2d = comm.all_gather(m2d.transpose(0, 1).contiguous()).transpose(0, 1)
                rad = comm.all_gather(rad.transpose(0, 1).contiguous()).transpose(0, 1)
                B = normal_maps.shape[0]  # the caller's 1/W makes it the share
            m2d = m2d.reshape(B, -1, 2)
            rad = rad.reshape(B, -1, 2)
            nl = sum(NL.masked_progressive_normal_loss(
                g_norm, NL.sample_normals_from_map(normal_maps[b], m2d[b]),
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

    def _ut_centres(self, params, batch, width, height):
        """(means2d, radii) of ``params`` against the batch's cameras by the
        differentiable unscented projection, with the options the eval3d
        render projects with (its own projection carries no gradient).
        Blocked: this block against every camera of the global batch, as
        ``parallel.sharded_render`` projects it."""
        cfg = self.cfg
        viewmats, Ks = batch["viewmat"], batch["K"]
        if self._blocked(params):
            viewmats, Ks = comm.all_gather(viewmats), comm.all_gather(Ks)
        radii, means2d, _, _, _ = fully_fused_projection_with_ut(
            params["means"], params["quats"], torch.exp(params["scales"]),
            torch.sigmoid(params["opacities"]), viewmats, Ks, width, height,
            near_plane=cfg.near_plane, far_plane=cfg.far_plane, camera_model=cfg.camera_model)
        return means2d, radii

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
        first image or None). Under sharding each term is this rank's share
        (the CGC loss over its images, the regularizer on the gathered
        features, alike on every rank, over W) and the head's gradients are
        summed over the ranks."""
        cfg = self.cfg
        blocked = self._blocked(params)
        world = self.mesh.world if blocked else 1
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
            terms["segloss"] = cfg.seg_loss_weight * seg / B / world
            if quality:
                cq = seg_losses.cluster_quality(fmap[0].detach(), batch["instance_mask"][0])
        if use_spatial:
            feats_all, means_all = feats, params["means"]
            if blocked:
                feats_all = comm.all_gather(feats)
                means_all = comm.all_gather(params["means"].detach())
            terms["spatialreg"] = cfg.seg_spatial_weight * seg_losses.cgc_spatial_regularizer(
                feats_all, means_all, self.generator, k_near=cfg.cgc_k_near,
                k_far=cfg.cgc_k_far, lambda_near=cfg.cgc_lambda_near,
                lambda_far=cfg.cgc_lambda_far) / world
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
                if blocked:
                    g = self._world_sum(g)
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
        with span("render"):
            means, quats, scales, opacities, sh = G.splat_activations(params)
            kw = dict(sh_degree=sh_degree, render_mode="RGB+ED", distloss=cfg.dist_loss,
                      means2d_offset=tap, means2d_abs_tap=abs_tap,
                      tile_capacity=cfg.tile_capacity, isect_capacity=cfg.isect_capacity,
                      max_tiles_per_gauss=cfg.max_tiles_per_gauss, backgrounds=backgrounds,
                      rasterizer="packed")
            if self._blocked(params):
                # the surfel exchange (tdgs/training/trainer.py:654-680); the
                # normals come back in the camera frame
                img, alpha, normals_cam, distort, _, meta = rasterization_2dgs_sharded(
                    means, quats, scales, opacities, sh, batch["viewmat"], batch["K"], W, H,
                    self.mesh, **kw)
                c2w = torch.linalg.inv(batch["viewmat"])
                normals = rotate(c2w[..., :3, :3], normals_cam)
                normals_from_depth = depth_to_normal(img[..., -1:], c2w, batch["K"])
            else:
                img, alpha, normals, normals_from_depth, distort, _, meta = rasterization_2dgs(
                    means, quats, scales, opacities, sh, batch["viewmat"], batch["K"], W, H,
                    isect_exact=cfg.isect_exact, device=self.device, **kw)
        with span("loss"):
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
        with span("data"):
            items = [self.trainset[int(i)] for i in idx]
            dev = self.device

            def upload(a, dtype=None):
                # a copy from pageable host memory waits for the device's queue
                return host_read(a, "data", lambda x: torch.as_tensor(x, dtype=dtype, device=dev))

            batch = {k: upload(np.stack([it[src] for it in items]), torch.float32)
                     for k, src in (("image", "image"), ("viewmat", "viewmat"), ("K", "K"))}
            # the training set's indices: the rows of the per-image modules
            batch["image_id"] = upload(np.asarray(idx, np.int64))
            if all("mask" in it for it in items):
                batch["mask"] = upload(np.stack([it["mask"] for it in items]), torch.float32)
            if all("instance_mask" in it for it in items):
                batch["instance_mask"] = upload(
                    np.stack([it["instance_mask"] for it in items]).astype(np.int64))
            cfg = self.cfg
            if cfg.load_normals and all("normal" in it for it in items):
                batch["normal"] = upload(np.stack([it["normal"] for it in items]),
                                         torch.float32)
            if cfg.depth_loss:
                if cfg.use_precomputed_depths and all("refined_depth" in it for it in items):
                    batch["depth_map"] = upload(
                        np.stack([it["refined_depth"] for it in items]), torch.float32)
                else:
                    batch.update({k: upload(v) for k, v in self._depth_fields(items).items()})
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
        # under sharding each rank takes its cameras of every global batch
        world = self.mesh.world if self.mesh is not None else 1
        rank = self.mesh.rank if self.mesh is not None else 0
        per_rank = cfg.batch_size // world
        sync_viewer = self.mesh is not None and not cfg.disable_viewer
        last_log_step, last_log_time = start_step, time.time()
        nancheck = int(os.environ.get("TDGS_NANCHECK", "0") or 0)
        for step in range(start_step + 1, cfg.max_steps + 1):
            with span("step", step=step):
                if cursor + cfg.batch_size > len(order):
                    order = rng.permutation(len(self.trainset))
                    cursor = 0
                idx = order[cursor:cursor + cfg.batch_size][rank * per_rank:(rank + 1) * per_rank]
                # decode-ahead: the next steps' images decode while this one runs
                ahead = order[cursor + cfg.batch_size:cursor + 5 * cfg.batch_size]
                cursor += cfg.batch_size
                mine = np.arange(len(ahead)) % cfg.batch_size // per_rank == rank
                self.trainset.prefetch(ahead[mine])
                batch = self._batch(idx)
                H, W = batch["image"].shape[1:3]
                sh_degree = min(step // cfg.sh_degree_interval, cfg.sh_degree)
                # the segmentation cadence (tdgs/training/trainer.py:1100-1114)
                seg_live = cfg.with_segmentation and step >= cfg.seg_start_iter
                use_seg = (seg_live and step % cfg.seg_loss_every == 0
                           and "instance_mask" in batch)
                use_spatial = seg_live and step % cfg.seg_spatial_every == 0
                log_step = step % cfg.tb_every == 0 or step == cfg.max_steps
                # the live view sees the state between steps (tdgs/training/trainer.py:1154)
                with self.viewer_lock:
                    loss, aux = self.train_step(batch, step, sh_degree, use_seg=use_seg,
                                                use_spatial=use_spatial, seg_quality=log_step)
                    self.seg_steps += int(use_seg or use_spatial)

                    info = {"radii": aux["radii"], "width": W, "height": H}
                    if aux["v_means2d"] is not None:
                        self.strategy_state = self.strategy.update_state(
                            self.strategy_state, info, aux["v_means2d"])
                    refine_before = self.strategy.last_refine
                    # a device scalar: read (a host sync) only when a refine ran
                    alive_before = self._world_sum(G.alive_mask(self.splats).sum())
                    self.strategy_post_backward(step, info, aux["lr_means"])
                    if self.strategy.last_refine is not refine_before:
                        self.refines.append(dict(
                            step=step, **self.strategy.last_refine,
                            alive_before=host_read(alive_before, "refine_record", int),
                            alive_after=self._alive_count("refine_record")))
                    if (cfg.max_capacity and isinstance(self.strategy, DefaultStrategy)
                            and self.strategy.refine_start_iter <= step
                            <= self.strategy.refine_stop_iter
                            and step % self.strategy.refine_every == 0):
                        self.maybe_grow_capacity()
                if sync_viewer:
                    self._sync_viewer_copy()

                if nancheck and step % nancheck == 0 and not math.isfinite(
                        host_read(loss, "nancheck", float)):
                    bad = {k: int((~torch.isfinite(v)).sum()) for k, v in self.splats.items()
                           if not bool(torch.isfinite(v).all())}
                    raise FloatingPointError(f"non-finite loss at step {step}: "
                                             f"non-finite params={bad}")

                if log_step:
                    with span("log"):
                        history.append({"step": step, "loss": host_read(loss, "log", float)})
                        # rays a second over the steps since the last record, every
                        # rank's images counted (tdgs/training/trainer.py:1233-1267)
                        now = time.time()
                        rays_sec = (H * W * cfg.batch_size * (step - last_log_step)
                                    / max(now - last_log_time, 1e-9))
                        last_log_step, last_log_time = step, now
                        visible = self._world_sum(aux["visibility"].sum())
                        scalars = {
                            "train/loss": host_read(loss, "log", float),
                            "train/num_GS": self._alive_count("log"),
                            "train/visible_GS": host_read(visible, "log", int),
                            "train/rays_per_sec": rays_sec,
                            "train/sh_degree": sh_degree,
                            "train/mem_gb": (device_mem_gb() if self.device.type == "cuda"
                                             else None),
                        }
                        for named in (aux["loss_terms"], aux["seg_terms"]):
                            scalars.update({f"train/{k}": host_read(v, "log", float)
                                            for k, v in named.items()})
                        if aux["cluster_quality"] is not None:
                            intra, inter = aux["cluster_quality"]
                            scalars["train/cluster_intra"] = host_read(intra, "log", float)
                            scalars["train/cluster_inter"] = host_read(inter, "log", float)
                        if self.logger is not None:
                            self.logger.log(step, scalars)
                        if (cfg.save_depth_normal_vis and aux["depth"] is not None
                                and self.is_main):
                            self._save_depth_normal_vis(step, aux["depth"][0], batch)
                if step in cfg.eval_steps:
                    self.eval(step)
                if step in cfg.save_steps:
                    self.save_checkpoint(step)
                if cfg.save_ply and step in cfg.ply_steps:
                    self.export_ply(step)
        return {"history": history, "wall_time_s": time.time() - t0}

    @_under_viewer_lock
    def strategy_post_backward(self, step: int, info: Dict, lr: float) -> None:
        """The strategy's step after the update. Under sharding a refine or
        an opacity reset runs on the rows gathered whole, with the same
        generator on every rank (so every rank draws alike) and each keeps
        its block; the MCMC position noise of the other steps is drawn for
        every row and each rank applies its block's."""
        with span("strategy"):
            strat = self.strategy
            if not self._blocked(self.splats):
                self.splats, self.opt_state, self.strategy_state = strat.step_post_backward(
                    self.splats, self.opt_state, self.strategy_state, step, info,
                    self.generator, lr=lr)
                return
            if isinstance(strat, MCMCStrategy) and not strat.refines_at(step):
                n = self.capacity // self.mesh.world
                block = slice(self.mesh.rank * n, (self.mesh.rank + 1) * n)
                with span("noise"):
                    noise = torch.randn((self.capacity, 3), generator=self.generator,
                                        device=self.device)[block]
                    active = (torch.arange(self.capacity, device=self.device)
                              < int(self.strategy_state["n_alive"]))[block]
                    self.splats = inject_noise_to_position(self.splats, noise,
                                                           lr * strat.noise_lr,
                                                           active_mask=active)
                return
            if isinstance(strat, DefaultStrategy) and not strat.acts_at(step):
                return
            whole = self._gather(self._trees()).values()
            whole = strat.step_post_backward(*whole, step, info, self.generator, lr=lr)
            self._set_trees(self._shard(dict(zip(rows.TREES, whole))))

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
        """Stop the live viewer and the training set's decode-ahead
        threads, close the metrics log, and leave the world this runner
        joined."""
        if self.viewer is not None:
            self.viewer.shutdown()
            self.viewer = None
        if self.logger is not None:
            self.logger.close()
            self.logger = None
        self.trainset.close()
        if self._owns_world and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval(self, step: int, stage: str = "val", splats=None) -> Dict[str, Any]:
        """PSNR, SSIM and LPIPS over the test views, rendered by the
        forward-only ``packed_inference`` rasterizer (the appearance
        module's colours with zero embeddings); writes
        stats/{stage}_step{step}.json. LPIPS is learned with local weights
        (key ``lpips``), else the random-filter proxy (``lpips_proxy``, not
        comparable to learned values); ``lpips_impl`` names it. With the
        bilateral grids also ``cc_psnr``, ``cc_ssim`` and ``cc_`` + the
        LPIPS key, scored after the least-squares colour correction
        (``bilateral_grid.color_correct``). ``splats`` default to the
        runner's, whole (gathered on every rank under sharding, each rank
        scoring every view; rank 0 writes)."""
        cfg = self.cfg
        splats = self._replicated_splats() if splats is None else splats
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
                splats, torch.as_tensor(d["viewmat"], device=self.device)[None],
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
            if cfg.tb_save_image and self.is_main:
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
        out["num_GS"] = int(G.alive_mask(splats).sum())
        if self.is_main:
            with open(os.path.join(self.stats_dir, f"{stage}_step{step}.json"), "w") as f:
                json.dump(out, f)
        if self.logger is not None:
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
        splats = self._replicated_splats()
        frames = []
        for c in path:
            c2w4 = np.eye(4, dtype=np.float32)
            c2w4[:3] = c
            viewmat = torch.as_tensor(np.linalg.inv(c2w4).astype(np.float32),
                                      device=self.device)[None]
            img, _, _ = self.rasterize_splats(splats, viewmat, K, W, H,
                                              self.cfg.sh_degree, render_mode="RGB+ED",
                                              rasterizer="packed_inference")
            frames.append((torch.clamp(img[0, ..., :3], 0, 1) * 255).to(torch.uint8))
        return [f.cpu().numpy() for f in frames]

    def write_traj(self, step: int, frames) -> str:
        """``traj_{step}.gif`` of the frames where PIL imports, else
        ``traj_{step}/frame_{i:04d}.png``; returns the path (rank 0
        writes)."""
        try:
            from PIL import Image
        except ImportError:
            from tdgs_torch.utils.png import write_png

            out = os.path.join(self.cfg.result_dir, f"traj_{step}")
            if self.is_main:
                os.makedirs(out, exist_ok=True)
                for i, f in enumerate(frames):
                    write_png(os.path.join(out, f"frame_{i:04d}.png"), f)
            return out
        out = os.path.join(self.cfg.result_dir, f"traj_{step}.gif")
        if not self.is_main:
            return out
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(out, save_all=True, append_images=imgs[1:], duration=33, loop=0)
        return out

    # ------------------------------------------------------------------
    def _state(self, step: int) -> Dict[str, Any]:
        """The checkpoint's content as tensors, under the JAX package's keys
        (under sharding this rank's blocks of the rows)."""
        state = {
            "step": int(step),
            "splats": self.splats,
            "opt_state": self.opt_state,
            "strategy_state": dict(self.strategy_state),
        }
        if self.seg_head is not None:
            state["segmentation_head"] = self.seg_head.params()
        return state

    def state_numpy(self, step: int) -> Dict[str, Any]:
        """The checkpoint's content: the JAX package's keys, holding only
        builtins and numpy arrays, the rows whole (collective under
        sharding)."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

        state = self._state(step)
        if self.mesh is not None:
            state = self._gather(state)
        return tree_map(host, state)

    def save_checkpoint(self, step: int) -> str:
        """Step, splats, Adam moments and strategy state, in the container
        of ``Config.ckpt_format``: a pickle (rank 0 writes the gathered
        rows) or, for ``"orbax"``, the directory of ``parallel/
        checkpoint.py`` (each rank writes its block)."""
        if self.cfg.ckpt_format == "orbax":
            from tdgs_torch.parallel import checkpoint

            path = os.path.abspath(os.path.join(self.ckpt_dir, f"ckpt_{step}"))
            return checkpoint.save(path, self._state(step), self.capacity,
                                   self.mesh if self._blocked(self.splats) else None)
        path = os.path.join(self.ckpt_dir, f"ckpt_{step}.pkl")
        state = self.state_numpy(step)
        if self.is_main:
            with open(path, "wb") as f:
                pickle.dump(state, f)
        return path

    @_under_viewer_lock
    def load_state_numpy(self, state: Dict[str, Any], blocks: bool = False) -> int:
        """Restore from the checkpoint's content (see ``state_numpy``;
        arrays or tensors). Under sharding the rows are cut to this rank's
        block, unless ``blocks`` says they are that block already. A
        ``segmentation_head`` replaces the head; its Adam moments restart
        at zero, as the JAX package's checkpoints do not hold them."""
        def dev(x):
            if isinstance(x, (np.ndarray, torch.Tensor)):
                return torch.as_tensor(x, device=self.device)
            return x

        self.splats = tree_map(dev, state["splats"])
        self.capacity = self.splats["means"].shape[0] * (
            self.mesh.world if blocks and self.mesh is not None else 1)
        self.opt_state = tree_map(dev, state["opt_state"])
        self.strategy_state.update(tree_map(dev, state["strategy_state"]))
        if self.mesh is not None and not blocks:
            self._set_trees(self._shard(self._trees()))
        if "segmentation_head" in state:
            self.seg_head = seg_head_mod.head_from_numpy(state["segmentation_head"],
                                                         device=self.device)
            self.seg_opt_state = self._zero_head_moments()
        return int(state["step"])

    def load_checkpoint(self, path: str) -> int:
        """Resume from either container: a pickle file, or a directory of
        ``parallel/checkpoint.py`` (re-blocked to this world's ranks, or
        read whole on one device)."""
        if os.path.isdir(path):
            from tdgs_torch.parallel import checkpoint

            return self.load_state_numpy(checkpoint.load(path, self.mesh, self.device),
                                         blocks=self.mesh is not None)
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
        splats = self._replicated_splats()
        feats = seg_head_mod.apply_segmentation_head(self.seg_head,
                                                     splats["identity_encodings"])
        fmap, _, _ = self.rasterize_splats(
            splats, torch.as_tensor(d["viewmat"], device=self.device)[None],
            torch.as_tensor(d["K"], device=self.device)[None], W, H, self.cfg.sh_degree,
            rasterizer="packed_inference", override_features=feats)
        return fmap[0].cpu().numpy()

    def export_ply(self, step: int, format: str = "ply") -> str:
        """The alive splats at ``step`` through ``export_splats`` (dead rows
        dropped; gathered under sharding, rank 0 writes):
        ply/point_cloud_{step}.ply ("ply", with the extra per-gaussian
        arrays such as identity encodings; "ply_compressed") or .splat
        ("splat"). Returns the path."""
        from tdgs_torch.utils.ply import export_splats

        splats = self._replicated_splats()
        keep = G.alive_mask(splats)
        s = {k: v[keep].detach().cpu().numpy() for k, v in splats.items()}
        main = ("means", "scales", "quats", "opacities", "sh0", "shN")
        extra = {k: v for k, v in s.items() if k not in main}
        ply_dir = os.path.join(self.cfg.result_dir, "ply")
        os.makedirs(ply_dir, exist_ok=True)
        ext = "splat" if format == "splat" else "ply"
        out = os.path.join(ply_dir, f"point_cloud_{step}.{ext}")
        if self.is_main:
            export_splats(*(s[k] for k in main), format=format, save_to=out,
                          extra=extra if format == "ply" and extra else None)
        return out

    def run_compression(self, step: int) -> Dict[str, Any]:
        """Compress the alive splats (``compression.PngCompression``, its
        K-means on the runner's device) into result_dir/compression,
        decompress them and eval the round trip as stage ``compress``
        (stats/compress_step{step}.json); the splats are left as they
        were. Under sharding rank 0 compresses the gathered splats and every
        rank scores the decompressed ones."""
        from tdgs_torch.compression import PngCompression

        compress_dir = os.path.join(self.cfg.result_dir, "compression")
        splats = self._replicated_splats()
        keep = G.alive_mask(splats)
        method = PngCompression(device=self.device)
        if self.is_main:
            method.compress(compress_dir, {k: v[keep].detach().cpu().numpy()
                                           for k, v in splats.items()})
        if self.mesh is not None:
            torch.distributed.barrier()
        decompressed = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                        for k, v in method.decompress(compress_dir).items()}
        return self.eval(step, stage="compress", splats=decompressed)

    @_under_viewer_lock
    def maybe_grow_capacity(self) -> bool:
        """Double the capacity (up to ``max_capacity``) when the alive share
        passes ``capacity_growth_at``: new rows are dead, with zero moments
        and strategy accumulators. Under sharding the new capacity stays a
        multiple of the world (``tdgs/training/trainer.py:1555-1567``): the
        rows are gathered, padded and cut into the new blocks."""
        cfg = self.cfg
        if not cfg.max_capacity or self.capacity >= cfg.max_capacity:
            return False
        thresh = getattr(self.strategy, "prune_opa", 1.0 / 255.0)
        alive = int(self._world_sum((torch.sigmoid(self.splats["opacities"]) > thresh).sum()))
        if alive <= cfg.capacity_growth_at * self.capacity:
            return False
        old = self.capacity
        world = self.mesh.world if self.mesh is not None else 1
        new_cap = min(2 * old, int(cfg.max_capacity)) // world * world
        if new_cap <= old:
            return False
        trees = self._trees()
        if self._blocked(self.splats):
            trees = self._gather(trees)
        splats, opt_state, strategy_state = (trees[k] for k in rows.TREES)
        self.splats = G.pad_splats(splats, new_cap)
        self.opt_state = pad_rows(opt_state, old, new_cap)
        self.strategy_state = pad_rows(strategy_state, old, new_cap)
        self.capacity = new_cap
        if self.mesh is not None:
            self._set_trees(self._shard(self._trees()))
        return True
