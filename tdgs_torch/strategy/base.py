"""Strategy interface (port of ``tdgs/strategy/base.py``): params,
optimizer state and strategy state in, the same out. Tensors may be
updated in place where the JAX package rebuilt them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from tdgs_torch.models.gaussians import SplatParams


@dataclass
class Strategy:
    def check_sanity(self, params: SplatParams) -> None:
        for key in ("means", "scales", "quats", "opacities"):
            if key not in params:
                raise KeyError(f"{key} is required in params but missing.")

    def initialize_state(self, params: SplatParams, scene_scale: float = 1.0) -> Dict:
        raise NotImplementedError

    def step_pre_backward(self, state: Dict, step: int) -> Dict:
        return state

    def step_post_backward(
        self,
        params: SplatParams,
        opt_state: Any,
        state: Dict,
        step: int,
        info: Dict,
        generator: torch.Generator,
        lr: float,
    ) -> Tuple[SplatParams, Any, Dict]:
        raise NotImplementedError
