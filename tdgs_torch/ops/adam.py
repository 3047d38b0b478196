"""Selective Adam without bias correction (port of ``tdgs/ops/adam.py``).

Rows invisible in the current step (``visibility`` False) get neither a
moment update nor a parameter step. As in the JAX package, and unlike
``torch.optim.Adam``, there is no bias correction: the step is
``−lr · m / (√v + eps)``, so the first step moves every visible entry by
about ``lr / √(1 − b2) · (1 − b1) ≈ 3.16 · lr`` in the sign of its gradient.
The update is a masked dense pass (``torch.where``), with moments kept in
dicts keyed like the parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]


class SelectiveAdamState(NamedTuple):
    count: int  # step counter (for lr schedules)
    exp_avg: Params
    exp_avg_sq: Params


def _row_mask(visibility: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return visibility.reshape(visibility.shape + (1,) * (g.dim() - visibility.dim()))


def adam_moments(g, m, v, b1, b2, visibility=None):
    """One uncorrected Adam moment update → (m_new, v_new, vis mask or
    None); masked rows keep their moments."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    if visibility is None:
        return m_new, v_new, None
    vis = _row_mask(visibility, g)
    return torch.where(vis, m_new, m), torch.where(vis, v_new, v), vis


def selective_adam_step(g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, visibility=None):
    """→ (step, m_new, v_new): ``step = −lr·m_new/(√v_new + eps)``, zero on
    masked rows."""
    m_new, v_new, vis = adam_moments(g, m, v, b1, b2, visibility)
    step = -lr * m_new / (torch.sqrt(v_new) + eps)
    if vis is not None:
        step = torch.where(vis, step, torch.zeros_like(step))
    return step, m_new, v_new


def selective_adam(
    learning_rate: Union[float, Callable[[int], float]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """(init_fn, update_fn) of the functional transformation: ``update_fn
    (grads, state, visibility=None) → (steps, state)``, as the JAX
    package's optax transformation."""

    def init_fn(params: Params) -> SelectiveAdamState:
        return SelectiveAdamState(
            0,
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update_fn(grads: Params, state: SelectiveAdamState,
                  visibility: Optional[torch.Tensor] = None
                  ) -> Tuple[Params, SelectiveAdamState]:
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        steps, ms, vs = {}, {}, {}
        for k, g in grads.items():
            steps[k], ms[k], vs[k] = selective_adam_step(
                g, state.exp_avg[k], state.exp_avg_sq[k], lr, b1, b2, eps, visibility)
        return steps, SelectiveAdamState(state.count + 1, ms, vs)

    return init_fn, update_fn


class SelectiveAdam:
    """Stateful selective Adam with the reference optimizer's name and
    ``step(visibility)`` shape (gsplat/optimizers/selective_adam.py), over
    :func:`selective_adam_step`:

        opt = SelectiveAdam(params, lr=1e-3, eps=1e-8, betas=(0.9, 0.999))
        params = opt.step(grads, visibility=vis_mask)

    ``params`` and ``grads`` are dicts of tensors; ``lr`` a scalar or a
    dict keyed like ``params`` (per-group learning rates). No bias
    correction; masked-out rows keep their moments and value. ``step``
    returns new tensors and leaves the old ones untouched."""

    def __init__(self, params: Params, lr: Union[float, Dict[str, float]] = 1e-3,
                 eps: float = 1e-8, betas=(0.9, 0.999)):
        self.params = dict(params)
        self.lr = lr
        self.eps = eps
        self.b1, self.b2 = betas
        self.exp_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Params, visibility: Optional[torch.Tensor] = None) -> Params:
        for k, p in self.params.items():
            lr = self.lr[k] if isinstance(self.lr, dict) else self.lr
            step, self.exp_avg[k], self.exp_avg_sq[k] = selective_adam_step(
                grads[k], self.exp_avg[k], self.exp_avg_sq[k], lr, self.b1, self.b2,
                self.eps, visibility)
            self.params[k] = p + step
        return self.params
