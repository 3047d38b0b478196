"""Carry the JAX package's parameters and training state across to the
port, and back.

Each function takes arrays as numpy gives them (``np.asarray`` of the JAX
pytrees works on the arrays directly) and returns the port's tensors on
``device``; the ``*_to_numpy`` functions go the other way. Training state
is the JAX ``Runner``'s: ``splats``, the Adam moments ``opt_state`` (``mu``
and ``nu``, or a selective-Adam ``count``/``exp_avg``/``exp_avg_sq``) and
the strategy state (the DefaultStrategy's ``grad2d``/``count``/
``radii_norm``, the MCMCStrategy's ``binoms`` and ``n_alive``). A training
``Config`` goes across as a dict of builtins (``config_to_dict``,
``config_from_dict``), its strategy included. The image-fitting example's
parameters (``means``, ``scales``, ``quats``, ``opacities``, ``colors``)
go across with ``image_fitting_params_from_numpy`` and back with
``image_fitting_params_to_numpy``. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.ops.adam import SelectiveAdamState
from tdgs_torch.physics.bodies import BodyState, RigidBodies
from tdgs_torch.strategy.ops import tree_map


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)


def splats_from_numpy(splats: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Splat parameter dict (means, quats, scales, opacities, sh0, shN, ...)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in splats.items()}


IMAGE_FITTING_KEYS = ("means", "scales", "quats", "opacities", "colors")


def image_fitting_params_from_numpy(params: Mapping[str, Any],
                                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The image-fitting parameter dict (``examples/image_fitting.py
    init_params``, or a fitted state) → float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: _tensor(params[k], dev) for k in IMAGE_FITTING_KEYS}


def image_fitting_params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's image-fitting parameters → float32 numpy arrays."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in IMAGE_FITTING_KEYS}


def bodies_from_numpy(bodies: Any, device: DeviceLike = None) -> RigidBodies:
    """Any object or mapping with the RigidBodies fields."""
    dev = resolve_device(device)
    return RigidBodies(*[_tensor(_field(bodies, f), dev) for f in RigidBodies._fields])


def state_from_numpy(state: Any, device: DeviceLike = None) -> BodyState:
    """Any object or mapping with the BodyState fields (x, q, v, w)."""
    dev = resolve_device(device)
    return BodyState(*[_tensor(_field(state, f), dev) for f in BodyState._fields])


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of arrays → the same nesting of tensors on
    ``device`` (floating arrays as float32, integer arrays keep their
    type); Python scalars stay as they are."""
    dev = resolve_device(device)

    def f(x):
        if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
            a = np.asarray(x)
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            return torch.as_tensor(np.array(a), device=dev)
        return x

    return tree_map(f, tree)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of ``tree_from_numpy``: tensors → numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    """The fields of a training ``Config`` (the port's or the JAX
    package's: the same dataclass fields) as a dict, the strategy as
    ``{"type": class name, **its fields}``."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "strategy":
            v = {"type": type(v).__name__,
                 **{g.name: getattr(v, g.name) for g in dataclasses.fields(v) if g.compare}}
        out[f.name] = v
    return out


def config_from_dict(d: Mapping[str, Any]):
    """The port's ``Config`` from ``config_to_dict``'s output; a strategy
    type the port does not have raises."""
    from tdgs_torch import strategy as strategies
    from tdgs_torch.training.config import Config

    kw = dict(d)
    strat = dict(kw.pop("strategy"))
    cls = getattr(strategies, strat.pop("type"))
    return Config(strategy=cls(**strat), **kw)


def runner_state_from_numpy(state: Mapping[str, Any], device: DeviceLike = None) -> Dict:
    """A Runner's state with the JAX package's checkpoint keys (``step``,
    ``splats``, ``opt_state``, ``strategy_state``) as numpy → tensors, ready
    for ``tdgs_torch.training.trainer.Runner.load_state_numpy``."""
    out = {k: tree_from_numpy(dict(state[k]), device)
           for k in ("splats", "opt_state", "strategy_state")}
    out["step"] = int(state["step"])
    return out


def runner_state_to_numpy(state: Mapping[str, Any]) -> Dict:
    out = {k: tree_to_numpy(state[k]) for k in ("splats", "opt_state", "strategy_state")}
    out["step"] = int(state["step"])
    return out


def adam_state_from_numpy(state: Any, device: DeviceLike = None) -> SelectiveAdamState:
    """The JAX package's ``SelectiveAdamState`` (count, exp_avg,
    exp_avg_sq), or any object or mapping with those fields."""
    return SelectiveAdamState(
        int(np.asarray(_field(state, "count"))),
        tree_from_numpy(dict(_field(state, "exp_avg")), device),
        tree_from_numpy(dict(_field(state, "exp_avg_sq")), device),
    )
