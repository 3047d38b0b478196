"""Which leaves of the ``Runner``'s state are per-gaussian rows.

Under ``Config.sharded`` each rank holds every per-gaussian array as its
block of capacity / W rows (the JAX ``Runner._shard_gauss``,
``tdgs/training/trainer.py:310``) and every other leaf whole. The trainer's
shard and gather and the sharded checkpoint all ask here, by the leaf's
place in the state (its keys from the root, as the checkpoint names
them), never by its shape:

- ``splats``: every array;
- ``opt_state``: every array (the Adam moments of the splats; a step
  counter is a Python int);
- ``strategy_state``: the accumulators named in ``STRATEGY_ROWS``; the rest
  (``scene_scale``, MCMC's ``binoms`` and ``n_alive``) is whole;
- anything else (``step``, ``segmentation_head``): whole.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

# the trees of the state that hold rows, in the order the strategies take them
TREES = ("splats", "opt_state", "strategy_state")
# DefaultStrategy's per-gaussian accumulators
STRATEGY_ROWS = frozenset({"grad2d", "count", "radii_norm"})


def is_rows(path: Sequence[str], ndim: int) -> bool:
    """Is the array of ``ndim`` axes at ``path`` (keys from the state's
    root, e.g. ``("opt_state", "mu", "means")``) per-gaussian rows?"""
    if ndim < 1 or not path:
        return False
    if path[0] in ("splats", "opt_state"):
        return True
    return path[0] == "strategy_state" and path[-1] in STRATEGY_ROWS


def map_rows(fn: Callable[[torch.Tensor], torch.Tensor], state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` (a dict under the checkpoint's keys, holding any of
    ``TREES``) with ``fn`` applied to each per-gaussian array; every other
    leaf as it is."""
    return {key: _map_tree(fn, tree, (key,)) if key in TREES else tree
            for key, tree in state.items()}


def _map_tree(fn, tree, path):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, torch.Tensor) and is_rows(path, tree.dim()):
        return fn(tree)
    return tree
