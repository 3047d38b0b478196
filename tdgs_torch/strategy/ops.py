"""Strategy primitives at fixed capacity (port of ``tdgs/strategy/ops.py``):
masked writes into dead rows instead of growing the arrays, so shapes stay
those of the capacity.

Optimizer and strategy state are nested dicts (or tuples) of tensors; an
operation touches every floating tensor whose leading dim is the capacity.
The MCMC operations come in two halves: a draw from a ``torch.Generator``
(``mcmc_sample_sources``, ``position_noise``) and a deterministic core that
takes the drawn indices or noise (``refine_mcmc``,
``inject_noise_to_position``), so that a test can hand the core the JAX
package's draws.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from tdgs_torch.models.gaussians import DEAD_OPACITY_LOGIT, SplatParams
from tdgs_torch.ops.mcmc_noise import inject_noise_to_position  # noqa: F401 (re-exported)
from tdgs_torch.ops.relocation import compute_relocation
from tdgs_torch.ops.transforms import quat_to_rotmat
from tdgs_torch.utils.profiler import host_read

_EPS = float(torch.finfo(torch.float32).eps)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def zero_opt_rows(opt_state: Any, mask: torch.Tensor) -> Any:
    """Zero the rows where ``mask`` is True of every floating tensor whose
    leading dim is the capacity (integer step counters are left alone)."""
    C = mask.shape[0]

    def f(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and leaf.shape[0] == C
                and leaf.is_floating_point()):
            m = mask.reshape((C,) + (1,) * (leaf.dim() - 1))
            return torch.where(m, torch.zeros_like(leaf), leaf)
        return leaf

    return tree_map(f, opt_state)


def pad_rows(tree: Any, old_capacity: int, new_capacity: int) -> Any:
    """Pad every tensor whose leading dim is ``old_capacity`` with zero rows
    up to ``new_capacity``: the new rows are dead slots, and zero moments or
    accumulators are what a freshly granted slot gets anyway."""
    pad = new_capacity - old_capacity
    if pad < 0:
        raise ValueError(f"new capacity {new_capacity} < {old_capacity}")

    def f(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and leaf.shape[0] == old_capacity:
            return torch.cat([leaf, leaf.new_zeros((pad,) + tuple(leaf.shape[1:]))])
        return leaf

    return tree_map(f, tree)


def _logit(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) - torch.log1p(-x)


def grow_and_prune_default(
    params: SplatParams,
    opt_state: Any,
    generator: torch.Generator,
    grad2d: torch.Tensor,  # [C] accumulated screen-grad norms
    count: torch.Tensor,  # [C] visibility counts
    radii_norm: torch.Tensor,  # [C] max normalized screen radius seen
    scene_scale: float,
    grow_grad2d: float = 0.0002,
    grow_scale3d: float = 0.01,
    grow_scale2d: float = 0.05,
    prune_opa: float = 0.005,
    prune_scale3d: float = 0.1,
    prune_scale2d: float = 0.15,
    use_scale2d: bool = False,
    prune_too_big: bool = False,
    revised_opacity: bool = False,
) -> Tuple[SplatParams, Any, Dict[str, torch.Tensor]]:
    """One DefaultStrategy refine at fixed capacity.

    - duplicate: high screen gradient and small 3D scale → a copy in a free
      (dead) row;
    - split: high screen gradient and large scale (or large 2D radius) →
      two children drawn from the parent's gaussian with scales / 1.6; one
      overwrites the parent, one takes a free row;
    - prune: too large, when ``prune_too_big`` (opacity below ``prune_opa``
      is already the dead state).

    Requests beyond the free rows are dropped, lowest gradient first.
    Returns (params, opt_state, counts of dupli/split/prune/granted)."""
    C = params["means"].shape[0]
    dev = params["means"].device
    op = torch.sigmoid(params["opacities"])
    alive = op > prune_opa
    g_avg = grad2d / torch.clamp(count, min=1.0)

    scale_max = torch.exp(params["scales"]).max(dim=-1).values
    is_grad_high = (g_avg > grow_grad2d) & alive
    is_small = scale_max <= grow_scale3d * scene_scale
    is_dupli = is_grad_high & is_small
    is_split = is_grad_high & ~is_small
    if use_scale2d:
        is_split = is_split | (alive & (radii_norm > grow_scale2d))

    # prune first (frees rows)
    too_big = scale_max > prune_scale3d * scene_scale
    if use_scale2d:
        too_big = too_big | (radii_norm > prune_scale2d)
    prune = (alive & too_big) if prune_too_big else torch.zeros_like(alive)
    opacities = torch.where(prune, torch.full_like(params["opacities"], DEAD_OPACITY_LOGIT),
                            params["opacities"])
    params = dict(params, opacities=opacities)
    alive = alive & ~prune
    is_dupli = is_dupli & ~prune
    is_split = is_split & ~prune

    # grant free rows to requests, highest gradient first
    request = (is_dupli | is_split) & alive
    free = ~alive
    req_score = torch.where(request, g_avg, torch.full_like(g_avg, -math.inf))
    src = torch.argsort(-req_score, stable=True)
    dst = torch.argsort(torch.where(free, 0, 1), stable=True)
    n_grant = torch.minimum(request.sum(), free.sum())
    granted = torch.arange(C, device=dev) < n_grant

    # children drawn from the parent's gaussian: mean + R·diag(s)·ε
    eps1 = torch.randn((C, 3), generator=generator, device=dev)
    eps2 = torch.randn((C, 3), generator=generator, device=dev)
    L = quat_to_rotmat(params["quats"]) * torch.exp(params["scales"])[:, None, :]
    samp1 = params["means"] + torch.einsum("nij,nj->ni", L, eps1)
    samp2 = params["means"] + torch.einsum("nij,nj->ni", L, eps2)
    split_scales = params["scales"] - math.log(1.6)
    if revised_opacity:
        new_op_logit = _logit(torch.clamp(1.0 - torch.sqrt(1.0 - op), 1e-6, 1 - 1e-6))
    else:
        new_op_logit = params["opacities"]

    def child(sample):
        out = {}
        for name, p in params.items():
            m = is_split.reshape((C,) + (1,) * (p.dim() - 1))
            if name == "means":
                p = torch.where(m, sample, p)
            elif name == "scales":
                p = torch.where(m, split_scales, p)
            elif name == "opacities":
                p = torch.where(m, new_op_logit, p)
            out[name] = p
        return out

    # split parents become child A in place; child B (or the duplicate copy)
    # goes to a granted free row
    new_params = child(samp1)
    child_b = child(samp2)
    rows_src, rows_dst = src[granted], dst[granted]
    for name in new_params:
        new_params[name] = new_params[name].clone()
        new_params[name][rows_dst] = child_b[name][rows_src]

    touched_new = torch.zeros_like(alive)
    touched_new[rows_dst] = True
    opt_state = zero_opt_rows(opt_state, is_split | touched_new | prune)
    info = {
        "n_dupli": is_dupli.sum(),
        "n_split": is_split.sum(),
        "n_prune": prune.sum(),
        "n_granted": n_grant,
    }
    return new_params, opt_state, info


def reset_opacities(params: SplatParams, opt_state: Any,
                    value: float = 0.01) -> Tuple[SplatParams, Any]:
    """Clamp opacities to ≤ ``value`` and zero the moments shaped like them."""
    cap = _logit(torch.tensor(value, dtype=torch.float32)).item()
    new_logit = torch.clamp(params["opacities"], max=cap)
    params = dict(params, opacities=new_logit)

    def f(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.shape == new_logit.shape
                and leaf.is_floating_point()):
            return torch.zeros_like(leaf)
        return leaf

    return params, tree_map(f, opt_state)


def mcmc_sample_sources(params: SplatParams, generator: torch.Generator, n_before: int,
                        min_opacity: float = 0.005) -> Optional[torch.Tensor]:
    """One source row [C] (int64) per row of the capacity, drawn from the
    alive rows of the active region [0, n_before) with probability ∝
    opacity; None when no row is alive."""
    op = torch.sigmoid(params["opacities"])
    slots = torch.arange(op.shape[0], device=op.device)
    alive = (slots < n_before) & (op > min_opacity)
    if not host_read(alive.any(), "mcmc_refine", bool):
        return None
    probs = torch.where(alive, op, torch.zeros_like(op))
    return torch.multinomial(probs, op.shape[0], replacement=True, generator=generator)


def refine_mcmc(
    params: SplatParams,
    opt_state: Any,
    sampled: torch.Tensor,  # [C] int: each row's drawn source
    n_before: int,  # active-region size before this refine
    n_target: int,  # active-region size after (≥ n_before)
    binoms: torch.Tensor,
    min_opacity: float = 0.005,
) -> Tuple[SplatParams, Any, torch.Tensor]:
    """One MCMC refine at fixed capacity: relocate the dead rows of the
    active region and activate the new rows [n_before, n_target).

    Every target row (dead in the active region, or new) takes the
    parameters of its drawn source, and both get the Eq.-9 relocation
    opacity and scale (``compute_relocation``, with the count of targets
    that drew the source, plus the source itself); the optimizer moments of
    every touched row are zeroed. Returns (params, opt_state, number of
    dead rows relocated)."""
    C = params["means"].shape[0]
    op = torch.sigmoid(params["opacities"])
    slots = torch.arange(C, device=op.device)
    dead = (slots < n_before) & (op <= min_opacity)
    target = dead | ((slots >= n_before) & (slots < n_target))
    sampled = sampled.to(torch.int64)

    cnt = torch.zeros(C, dtype=torch.int64, device=op.device).index_add_(
        0, sampled, target.to(torch.int64))
    ratios = cnt[sampled] + 1
    new_op, new_scales = compute_relocation(op[sampled], torch.exp(params["scales"][sampled]),
                                            ratios, binoms)
    new_op_logit = _logit(torch.clamp(new_op, min_opacity, 1.0 - _EPS))
    new_log_scales = torch.log(torch.clamp(new_scales, min=1e-12))

    # the sources first: every target that drew a source writes the same
    # values into it
    # each boolean index finds the targets on the host: one sync each
    src = host_read(target, "mcmc_refine", sampled.__getitem__)
    opacities = params["opacities"].clone()
    opacities[src] = host_read(target, "mcmc_refine", new_op_logit.__getitem__)
    scales = params["scales"].clone()
    scales[src] = host_read(target, "mcmc_refine", new_log_scales.__getitem__)
    upd = dict(params, opacities=opacities, scales=scales)

    # then the targets copy their (updated) sources
    out = {}
    for name, p in upd.items():
        m = target.reshape((C,) + (1,) * (p.dim() - 1))
        out[name] = torch.where(m, p[sampled], p)
    opt_state = zero_opt_rows(opt_state, target | (cnt > 0))
    return out, opt_state, dead.sum()


def position_noise(params: SplatParams, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise shaped like the means."""
    means = params["means"]
    return torch.randn(means.shape, generator=generator, device=means.device)
