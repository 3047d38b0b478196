"""Default 3DGS densification strategy at fixed capacity (port of
``tdgs/strategy/default.py``): accumulate pixel-normalized screen-space
gradients per gaussian, then every ``refine_every`` steps duplicate, split
and prune into the dead rows of the capacity, and reset opacities every
``reset_every`` steps. The trainer hands in the screen-space gradient from
its ``means2d_offset`` tap (or the AbsGS tap). From ``refine_stop_iter`` on
the strategy does nothing, as gsplat's ``step_post_backward`` returns at
once there: no refine, no opacity reset, and no screen-gradient state to
accumulate (``reads_grads``). The JAX package keeps resetting past the
stop."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from tdgs_torch.models.gaussians import SplatParams
from tdgs_torch.strategy.base import Strategy
from tdgs_torch.strategy.ops import grow_and_prune_default, reset_opacities


@dataclass
class DefaultStrategy(Strategy):
    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    refine_scale2d_stop_iter: int = 0
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    absgrad: bool = False
    revised_opacity: bool = False
    verbose: bool = False
    # counts of the last refine (dupli, split, prune, granted), for reports
    last_refine: Optional[Dict[str, int]] = field(default=None, repr=False, compare=False)

    def initialize_state(self, params: SplatParams, scene_scale: float = 1.0) -> Dict:
        C = params["means"].shape[0]
        dev = params["means"].device
        return {
            "grad2d": torch.zeros((C,), device=dev),
            "count": torch.zeros((C,), device=dev),
            "radii_norm": torch.zeros((C,), device=dev),
            "scene_scale": scene_scale,
        }

    @torch.no_grad()
    def update_state(self, state: Dict, info: Dict, v_means2d: torch.Tensor) -> Dict:
        """Accumulate screen-gradient norms in pixel units (scaled by half
        the image size) and visibility counts. ``v_means2d``: [..., C, N, 2]
        gradient of the loss w.r.t. the projected means; ``info`` holds
        ``radii`` [..., C, N, 2], ``width`` and ``height``."""
        W, H = float(info["width"]), float(info["height"])
        g = v_means2d * torch.tensor([W / 2.0, H / 2.0], device=v_means2d.device)
        gnorm = torch.linalg.vector_norm(g, dim=-1)  # [..., C, N]
        radii = info["radii"]
        visible = (radii > 0).all(dim=-1)
        lead = tuple(range(gnorm.dim() - 1))
        grad2d = state["grad2d"] + torch.where(visible, gnorm, torch.zeros_like(gnorm)).sum(lead)
        count = state["count"] + visible.sum(lead).to(state["count"].dtype)
        r = radii.max(dim=-1).values.to(torch.float32) / max(W, H)
        radii_norm = torch.maximum(state["radii_norm"], r.amax(dim=lead))
        return dict(state, grad2d=grad2d, count=count, radii_norm=radii_norm)

    @torch.no_grad()
    def step_post_backward(
        self,
        params: SplatParams,
        opt_state: Any,
        state: Dict,
        step: int,
        info: Dict,
        generator: torch.Generator,
        lr: float = 0.0,
    ) -> Tuple[SplatParams, Any, Dict]:
        del lr
        if self._refines(step):
            use_scale2d = 0 < self.refine_scale2d_stop_iter and (
                step < self.refine_scale2d_stop_iter
            )
            params, opt_state, ginfo = grow_and_prune_default(
                params, opt_state, generator, state["grad2d"], state["count"],
                state["radii_norm"], state["scene_scale"],
                grow_grad2d=self.grow_grad2d, grow_scale3d=self.grow_scale3d,
                grow_scale2d=self.grow_scale2d, prune_opa=self.prune_opa,
                prune_scale3d=self.prune_scale3d, prune_scale2d=self.prune_scale2d,
                use_scale2d=use_scale2d, prune_too_big=step > self.reset_every,
                revised_opacity=self.revised_opacity,
            )
            self.last_refine = {k: int(v) for k, v in ginfo.items()}
            if self.verbose:
                print(f"Step {step}: dupli {self.last_refine['n_dupli']} "
                      f"split {self.last_refine['n_split']} "
                      f"prune {self.last_refine['n_prune']} "
                      f"granted {self.last_refine['n_granted']}")
            C = params["means"].shape[0]
            dev = params["means"].device
            state = dict(
                state,
                grad2d=torch.zeros((C,), device=dev),
                count=torch.zeros((C,), device=dev),
                radii_norm=torch.zeros((C,), device=dev),
            )

        if self._resets(step):
            params, opt_state = reset_opacities(params, opt_state, value=2.0 * self.prune_opa)
        return params, opt_state, state

    def _refines(self, step: int) -> bool:
        return (
            self.refine_start_iter < step < self.refine_stop_iter
            and step % self.refine_every == 0
            and (
                self.pause_refine_after_reset == 0
                or step % self.reset_every >= self.pause_refine_after_reset
            )
        )

    def _resets(self, step: int) -> bool:
        return step % self.reset_every == 0 and 0 < step < self.refine_stop_iter

    def reads_grads(self, step: int) -> bool:
        """Does the strategy read the screen-space gradients of ``step``?
        Up to its stop: the trainer taps and accumulates them only then."""
        return step < self.refine_stop_iter

    def acts_at(self, step: int) -> bool:
        """Does ``step_post_backward`` change anything at ``step`` (a refine
        or an opacity reset)? The sharded trainer gathers the rows then."""
        return self._refines(step) or self._resets(step)
