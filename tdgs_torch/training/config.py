"""Training configuration (port of ``tdgs/training/config.py``).

The same dataclass fields and defaults as the JAX package, so command-line
flags parse alike. ``Config.check_ported`` (the trainer calls it) refuses
the combinations the trainer cannot run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Literal, Optional, Tuple

from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy, Strategy


@dataclass
class Config:
    # data
    data_dir: str = "data/360_v2/garden"
    data_factor: int = 4
    result_dir: str = "results/garden"
    test_every: int = 8
    normalize_world_space: bool = True
    patch_size: Optional[int] = None

    # run schedule
    max_steps: int = 30_000
    eval_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    ply_steps: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_ply: bool = False
    steps_scaler: float = 1.0
    batch_size: int = 1

    # model init
    init_type: Literal["sfm", "random"] = "sfm"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    sfm_max_points: Optional[int] = None
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_opa: float = 0.1
    init_scale: float = 1.0

    # render
    near_plane: float = 0.01
    far_plane: float = 1e10
    camera_model: Literal["pinhole", "ortho", "fisheye"] = "pinhole"
    antialiased: bool = False
    rasterizer: Literal["auto", "jax", "pallas", "packed", "packed_inference"] = "auto"
    tile_capacity: int = 1024
    isect_capacity: Optional[int] = None
    max_tiles_per_gauss: int = 32
    isect_exact: bool = False

    # model family; 3DGUT: with_ut projects through the unscented transform,
    # with_eval3d rasterizes in world space along the pixels' rays. eval3d
    # renders never touch means2d, so the DefaultStrategy's screen-gradient
    # criterion never grows anything there: 3DGUT trains with MCMCStrategy
    model_type: Literal["3dgs", "2dgs"] = "3dgs"
    with_ut: bool = False
    with_eval3d: bool = False

    # 2DGS losses
    normal_loss: bool = False
    normal_lambda: float = 5e-2
    normal_start_iter: int = 7_000
    dist_loss: bool = False
    dist_lambda: float = 1e-2
    dist_start_iter: int = 3_000

    # losses
    ssim_lambda: float = 0.2
    random_bkgd: bool = False
    background_color: Optional[Tuple[float, float, float]] = None
    max_scale: Optional[float] = None
    depth_loss: bool = False
    depth_lambda: float = 1e-2
    use_precomputed_depths: bool = False
    depth_normal_loss: bool = False
    depth_normal_start_step: int = 1000
    lambda_depth_smooth: float = 0.1
    lambda_normal_consistency: float = 0.01
    load_normals: bool = False
    start_normal_loss_step: int = 5000
    mono_normal_lambda: float = 0.1
    save_depth_normal_vis: bool = False
    opacity_reg: float = 0.0
    scale_reg: float = 0.0

    # learning rates
    means_lr: float = 1.6e-4
    scales_lr: float = 5e-3
    quats_lr: float = 1e-3
    opacities_lr: float = 5e-2
    sh0_lr: float = 2.5e-3
    shN_lr: float = 2.5e-3 / 20.0

    # strategy
    strategy: Strategy = field(default_factory=DefaultStrategy)
    capacity: Optional[int] = None
    max_capacity: Optional[int] = None
    capacity_growth_at: float = 0.85

    compression: Optional[str] = None
    render_traj_path: str = "interp"
    disable_video: bool = False
    global_scale: float = 1.0
    visible_adam: bool = True
    tb_save_image: bool = False
    ckpt_format: str = "pickle"
    sharded: bool = False

    # pose and appearance optimization
    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6
    feature_dim: int = 32
    pose_noise: float = 0.0

    # decode-ahead loading: the training images are decoded on a thread
    # pool a few steps before their step (datasets/prefetch.py)
    data_prefetch: bool = True

    # identity-vector segmentation
    with_segmentation: bool = False
    load_instance_masks: Optional[bool] = None
    identity_dim: int = 16
    identity_lr: float = 1.6e-3
    seg_start_iter: int = 1000
    seg_loss_every: int = 50
    seg_loss_weight: float = 0.3
    seg_spatial_every: int = 500
    seg_spatial_weight: float = 0.1
    cgc_min_cluster: int = 30
    cgc_k_near: int = 2
    cgc_k_far: int = 5
    cgc_lambda_near: float = 0.05
    cgc_lambda_far: float = 0.15

    # live viewer
    disable_viewer: bool = True
    viewer_port: int = 8080

    # misc
    seed: int = 42
    tb_every: int = 100
    use_bilateral_grid: bool = False
    bilateral_grid_shape: Tuple[int, int, int] = (16, 16, 8)
    lpips_net: str = "alex"

    def adjusted(self) -> "Config":
        """Scale all step-based schedules by ``steps_scaler``."""
        s = self.steps_scaler
        if s == 1.0:
            return self
        strat = self.strategy
        strat = dataclasses.replace(
            strat,
            refine_start_iter=int(strat.refine_start_iter * s),
            refine_stop_iter=int(strat.refine_stop_iter * s),
            refine_every=max(1, int(strat.refine_every * s)),
            **({"reset_every": max(1, int(strat.reset_every * s))}
               if isinstance(strat, DefaultStrategy) else {}),
        )
        return dataclasses.replace(
            self,
            max_steps=int(self.max_steps * s),
            eval_steps=[int(x * s) for x in self.eval_steps],
            save_steps=[int(x * s) for x in self.save_steps],
            ply_steps=[int(x * s) for x in self.ply_steps],
            sh_degree_interval=int(self.sh_degree_interval * s),
            strategy=strat,
            steps_scaler=1.0,
        )

    def check_ported(self) -> None:
        """Raise ``ValueError`` for a 3DGUT combination the trainer refuses
        (as the JAX Runner asserts: with_ut needs with_eval3d, eval3d is
        3DGS), an unknown checkpoint container or a forward-only training
        rasterizer."""
        if self.with_ut and not self.with_eval3d:
            raise ValueError("training with with_ut requires with_eval3d")
        if self.with_eval3d and self.model_type != "3dgs":
            raise ValueError("with_eval3d is a 3DGS render path")
        if self.ckpt_format not in ("pickle", "orbax"):
            raise ValueError(f"ckpt_format {self.ckpt_format!r}: 'pickle' or 'orbax' "
                             "(the port's sharded directory, parallel/checkpoint.py)")
        if self.rasterizer == "packed_inference":
            raise ValueError("rasterizer='packed_inference' is forward-only; "
                             "training needs 'packed' (or 'auto')")
