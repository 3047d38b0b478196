"""Carry the JAX package's parameters and training state across to the
port, and back.

Each function takes arrays as numpy gives them (``np.asarray`` of the JAX
pytrees works on the arrays directly) and returns the port's tensors on
``device``; the ``*_to_numpy`` functions go the other way. Training state
is the JAX ``Runner``'s: ``splats``, the Adam moments ``opt_state`` (``mu``
and ``nu``, or a selective-Adam ``count``/``exp_avg``/``exp_avg_sq``) and
the strategy state (the DefaultStrategy's ``grad2d``/``count``/
``radii_norm``, the MCMCStrategy's ``binoms`` and ``n_alive``), and with
segmentation the ``identity_encodings`` among the splats and the
``segmentation_head`` (``w1``, ``b1``, ``w2``, ``b2``). A training
``Config`` goes across as a dict of builtins (``config_to_dict``,
``config_from_dict``), its strategy included. The image-fitting example's
parameters (``means``, ``scales``, ``quats``, ``opacities``, ``colors``)
go across with ``image_fitting_params_from_numpy`` and back with
``image_fitting_params_to_numpy``. LPIPS filter banks go across with
``lpips_filters_from_numpy``. ``shard_rows`` cuts any such tree to one
rank's block of the gaussian rows, for the sharded ``Runner``. The
``Runner``'s auxiliary modules go
across with ``aux_params_from_numpy`` / ``aux_params_to_numpy`` (the JAX
``Runner``'s ``aux_params``: ``pose`` [n, 9], ``bilagrid``
[n, gh, gw, gg, 12], ``app_embeds`` [n, E] and ``app_mlp`` with ``w{i}``
[in, out], which the port's ``nn.Linear`` holds transposed) and their Adam
moments with ``aux_opt_state_from_numpy`` / ``aux_opt_state_to_numpy``;
the appearance mode's ``features`` and ``colors`` are splat arrays
(``splats_from_numpy``). Nothing here imports JAX.
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
    """Splat parameter dict (means, quats, scales, opacities, sh0, shN, and
    any extra per-gaussian array: ``identity_encodings``, the appearance
    mode's ``features`` and ``colors``)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in splats.items()}


# the port's parameter name in each single-tensor aux group
_AUX_NAMES = {"pose": "embeds", "bilagrid": "grids", "app_embeds": "embeds"}


def aux_params_to_numpy(groups: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """The port's ``Runner.aux_params()`` (or one part of its
    ``aux_opt_state``) → the JAX ``Runner``'s ``aux_params`` nesting: one
    array a group, ``app_mlp`` as {``w{i}`` [in, out], ``b{i}``}."""
    out: Dict[str, Any] = {}
    for group, params in groups.items():
        if group == "app_mlp":
            out[group] = {}
            for name, v in params.items():
                i, kind = name.split(".")
                a = v.detach().cpu().numpy()
                out[group][f"w{i}" if kind == "weight" else f"b{i}"] = (
                    a.T.copy() if kind == "weight" else a)
        else:
            out[group] = params[_AUX_NAMES[group]].detach().cpu().numpy()
    return out


def aux_params_from_numpy(tree: Mapping[str, Any],
                          device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``Runner``'s ``aux_params`` (or one part of its
    ``aux_opt_state``) → the port's groups of ``Runner.aux_params()``, for
    ``Runner.load_aux_state``."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, v in tree.items():
        if group == "app_mlp":
            out[group] = {}
            for name, a in v.items():
                i = name[1:]
                if name[0] == "w":
                    out[group][f"{i}.weight"] = _tensor(np.asarray(a).T, dev)
                else:
                    out[group][f"{i}.bias"] = _tensor(a, dev)
        else:
            out[group] = {_AUX_NAMES[group]: _tensor(v, dev)}
    return out


def aux_opt_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The aux Adam moments {mu, nu} → the JAX ``Runner``'s
    ``aux_opt_state``."""
    return {part: aux_params_to_numpy(state[part]) for part in ("mu", "nu")}


def aux_opt_state_from_numpy(state: Mapping[str, Any], device: DeviceLike = None) -> Dict:
    """The JAX ``Runner``'s ``aux_opt_state`` → the port's moments."""
    return {part: aux_params_from_numpy(state[part], device) for part in ("mu", "nu")}


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


_STATE_KEYS = ("splats", "opt_state", "strategy_state", "segmentation_head")


def runner_state_from_numpy(state: Mapping[str, Any], device: DeviceLike = None) -> Dict:
    """A Runner's state with the JAX package's checkpoint keys (``step``,
    ``splats``, ``opt_state``, ``strategy_state``, and
    ``segmentation_head`` where segmentation is on) as numpy → tensors,
    ready for ``tdgs_torch.training.trainer.Runner.load_state_numpy``."""
    out = {k: tree_from_numpy(dict(state[k]), device) for k in _STATE_KEYS if k in state}
    out["step"] = int(state["step"])
    return out


def runner_state_to_numpy(state: Mapping[str, Any]) -> Dict:
    out = {k: tree_to_numpy(dict(state[k])) for k in _STATE_KEYS if k in state}
    out["step"] = int(state["step"])
    return out


def shard_rows(tree: Any, rank: int, world: int, capacity: int) -> Any:
    """One rank's block of a tree of arrays (the JAX package's parameters,
    Adam moments or strategy state, as numpy): every array whose leading
    axis is ``capacity`` cut to rows ``[rank·n, (rank + 1)·n)``, n =
    capacity / world, as ``NamedSharding(P("gauss"))`` lays them out;
    anything else whole."""
    if capacity % world:
        raise ValueError(f"capacity {capacity} does not divide over {world} ranks")
    n = capacity // world

    def cut(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == capacity:
            return x[rank * n:(rank + 1) * n]
        return x

    return tree_map(cut, tree)


def adam_state_from_numpy(state: Any, device: DeviceLike = None) -> SelectiveAdamState:
    """The JAX package's ``SelectiveAdamState`` (count, exp_avg,
    exp_avg_sq), or any object or mapping with those fields."""
    return SelectiveAdamState(
        int(np.asarray(_field(state, "count"))),
        tree_from_numpy(dict(_field(state, "exp_avg")), device),
        tree_from_numpy(dict(_field(state, "exp_avg_sq")), device),
    )


def lpips_filters_from_numpy(bank: Any, device: DeviceLike = None) -> Any:
    """LPIPS weights → float32 tensors on ``device``, in the same nesting:
    the JAX package's proxy bank (``tdgs.training.metrics._filters()``, a
    tuple of [c_out, c_in, k, k] filters, for ``metrics.lpips(filters=...)``)
    or its learned weights (``_load_learned(net)``: convs as (w, b) pairs,
    then the lins)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), bank)
