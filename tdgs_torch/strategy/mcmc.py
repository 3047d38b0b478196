"""MCMC densification strategy at fixed capacity (port of
``tdgs/strategy/mcmc.py``, "3D Gaussian Splatting as MCMC",
arXiv:2404.09591):

- every ``refine_every`` steps in (refine_start_iter, refine_stop_iter):
  relocate the dead gaussians onto live ones drawn by opacity, and grow the
  live set by 5% up to the capacity (``cap_max``);
- every step: covariance-shaped position noise scaled by ``lr·noise_lr``
  and gated to low opacity.

The parameters are allocated at ``cap_max`` rows; the live count
``n_alive`` is a host integer in the strategy state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from tdgs_torch.models.gaussians import SplatParams
from tdgs_torch.ops.relocation import make_binoms
from tdgs_torch.strategy.base import Strategy
from tdgs_torch.strategy.ops import (
    inject_noise_to_position,
    mcmc_sample_sources,
    position_noise,
    refine_mcmc,
)
from tdgs_torch.utils.profiler import host_read, span


@dataclass
class MCMCStrategy(Strategy):
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100
    min_opacity: float = 0.005
    verbose: bool = False
    # counts of the last refine (relocated, n_alive), for reports
    last_refine: Optional[Dict[str, int]] = field(default=None, repr=False, compare=False)

    def initialize_state(self, params: SplatParams, scene_scale: float = 1.0,
                         n_alive: Optional[int] = None) -> Dict:
        C = params["means"].shape[0]
        if C > self.cap_max:
            raise ValueError(f"allocate the params at cap_max rows (got {C}, cap_max "
                             f"{self.cap_max})")
        if n_alive is None:
            n_alive = int((torch.sigmoid(params["opacities"]) > self.min_opacity).sum())
        return {"binoms": make_binoms(device=params["means"].device), "n_alive": n_alive}

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
        C = params["means"].shape[0]
        if self.refines_at(step):
            with span("refine"):
                n_before = int(state["n_alive"])
                n_target = min(C, int(1.05 * n_before))
                sampled = mcmc_sample_sources(params, generator, n_before, self.min_opacity)
                n_reloc = 0
                if sampled is not None:
                    params, opt_state, relocated = refine_mcmc(
                        params, opt_state, sampled, n_before, n_target, state["binoms"],
                        self.min_opacity)
                    n_reloc = host_read(relocated, "mcmc_refine", int)
                    state = dict(state, n_alive=n_target)
                self.last_refine = {"n_relocated": n_reloc, "n_alive": int(state["n_alive"])}
                if self.verbose:
                    print(f"Step {step}: relocated {n_reloc} GSs; now {state['n_alive']} "
                          f"live GSs.")

        with span("noise"):
            active = torch.arange(C, device=params["means"].device) < int(state["n_alive"])
            params = inject_noise_to_position(params, position_noise(params, generator),
                                              lr * self.noise_lr, active_mask=active)
        return params, opt_state, state

    def refines_at(self, step: int) -> bool:
        """Does ``step`` relocate and grow? The position noise comes every
        step."""
        return (self.refine_start_iter < step < self.refine_stop_iter
                and step % self.refine_every == 0)
