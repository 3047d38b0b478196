"""Selective Adam without bias correction (port of ``tdgs/ops/adam.py``).

Rows invisible in the current step (``visibility`` False) get neither a
moment update nor a parameter step. As in the JAX package, and unlike
``torch.optim.Adam``, there is no bias correction: the step is
``−lr · m / (√v + eps)``, so the first step moves every visible entry by
about ``lr / √(1 − b2) · (1 − b1) ≈ 3.16 · lr`` in the sign of its gradient.
The moments are kept in dicts keyed like the parameters.

:func:`adam_update` applies the update to every group at once: for CUDA
tensors in one launch of the hand-written kernel
``tdgs_torch/csrc/adam.cu`` (one pass over the parameters, gradients and
moments), for CPU tensors in the plain version, :func:`adam_update_plain`,
the masked dense chain of ``torch.where``s per group, which the kernel
repeats operation for operation.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from tdgs_torch.ops import _build

Params = Dict[str, torch.Tensor]
KERNEL = "adam"
MAX_GROUPS = 16  # groups one launch takes (csrc/adam.cu kMaxGroups)


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


def adam_update_plain(params: Params, grads: Params, mu: Params, nu: Params,
                      lrs: Dict[str, float], b1: float, b2: float, eps: float,
                      visibility: Optional[torch.Tensor] = None
                      ) -> Tuple[Params, Params, Params]:
    """The plain PyTorch version of :func:`adam_update`: per group of
    ``grads``, :func:`selective_adam_step` and ``params + step``."""
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        step, new_m[k], new_v[k] = selective_adam_step(g, mu[k], nu[k], lrs[k], b1, b2, eps,
                                                       visibility)
        new_p[k] = params[k] + step
    return new_p, new_m, new_v


@functools.cache
def _load_kernel():
    fn = _build.load(KERNEL).tdgs_adam
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Is each row of ``t`` (its first dimension) contiguous, and do the rows
    lie in order without overlap? The kernel reads such a gradient where
    it lies: the SH groups' gradients are slices of the gradient of their
    concatenation."""
    if t.dim() == 0 or t.shape[0] <= 1:
        return t.is_contiguous()
    return t[0].is_contiguous() and t.stride(0) >= t[0].numel()


def adam_update(params: Params, grads: Params, mu: Params, nu: Params,
                lrs: Dict[str, float], b1: float, b2: float, eps: float,
                visibility: Optional[torch.Tensor] = None
                ) -> Tuple[Params, Params, Params]:
    """Selective Adam without bias correction over every group of ``grads``
    → (params, mu, nu), each a dict of new tensors; the inputs are left
    untouched. ``lrs`` holds each group's learning rate; ``visibility``
    [rows] bool masks the first dimension of every group (None: all rows
    visible), and a masked row keeps its value and moments.

    CUDA tensors launch the CUDA kernel once for up to 16 groups (or raise):
    float32, all on one device, params and moments contiguous, each row of
    a gradient contiguous (the SH groups' gradients are slices of one, read
    where they lie). CPU tensors take the plain version."""
    if not grads:
        return {}, {}, {}
    if visibility is not None:
        if visibility.dtype != torch.bool or visibility.dim() != 1:
            raise TypeError(f"visibility: expected a 1-d bool tensor, got {visibility.dtype} "
                            f"{tuple(visibility.shape)}")
        for k, g in grads.items():
            if g.dim() == 0 or g.shape[0] != visibility.shape[0]:
                raise ValueError(f"grads[{k!r}]: shape {tuple(g.shape)}, visibility has "
                                 f"{visibility.shape[0]} rows")
    device = next(iter(grads.values())).device
    if device.type == "cpu":
        return adam_update_plain(params, grads, mu, nu, lrs, b1, b2, eps, visibility)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if len(grads) > MAX_GROUPS:
        raise ValueError(f"{len(grads)} groups: one launch takes at most {MAX_GROUPS}")
    if visibility is not None:
        if visibility.device != device:
            raise ValueError(f"visibility: expected device {device}, got {visibility.device}")
        visibility = visibility.contiguous()
    ptrs, sizes, widths, g_strides, lr_list = [], [], [], [], []
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        ins = {"params": params[k], "grads": g, "mu": mu[k], "nu": nu[k]}
        for what, t in ins.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{what}[{k!r}]: expected torch.float32, got {t.dtype}")
            if t.device != device:
                raise ValueError(f"{what}[{k!r}]: expected device {device}, got {t.device}")
            if not (_rows_contiguous(t) if what == "grads" else t.is_contiguous()):
                raise ValueError(f"{what}[{k!r}]: must be contiguous"
                                 + (" row by row" if what == "grads" else ""))
            if t.shape != g.shape:
                raise ValueError(f"{what}[{k!r}]: shape {tuple(t.shape)}, the gradient's "
                                 f"{tuple(g.shape)}")
        width = math.prod(g.shape[1:])
        new_p[k], new_m[k], new_v[k] = (torch.empty_like(params[k]) for _ in range(3))
        ptrs += [t.data_ptr() for t in (*ins.values(), new_p[k], new_m[k], new_v[k])]
        sizes.append(g.numel())
        widths.append(width)
        g_strides.append(g.stride(0) if g.dim() and g.shape[0] > 1 else width)
        lr_list.append(lrs[k])
    n = len(sizes)
    fn = _load_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn((ctypes.c_uint64 * (7 * n))(*ptrs), (ctypes.c_int64 * n)(*sizes),
                 (ctypes.c_int32 * n)(*widths), (ctypes.c_int64 * n)(*g_strides),
                 (ctypes.c_float * n)(*lr_list), n,
                 None if visibility is None else visibility.data_ptr(),
                 b1, 1.0 - b1, b2, 1.0 - b2, eps, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL)
    return new_p, new_m, new_v


def selective_adam(
    learning_rate: Union[float, Callable[[int], float]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """(init_fn, update_fn) of the functional transformation: ``update_fn
    (grads, state, visibility=None) → (steps, state)``, as the JAX
    package's optax transformation, over :func:`adam_update`."""

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
        # a step is the update of a zero parameter: 0 + step is the step
        zeros = {k: torch.zeros_like(g, memory_format=torch.contiguous_format)
                 for k, g in grads.items()}
        steps, ms, vs = adam_update(zeros, grads, state.exp_avg, state.exp_avg_sq,
                                    {k: lr for k in grads}, b1, b2, eps, visibility)
        return steps, SelectiveAdamState(state.count + 1, ms, vs)

    return init_fn, update_fn


class SelectiveAdam:
    """Stateful selective Adam with the reference optimizer's name and
    ``step(visibility)`` shape (gsplat/optimizers/selective_adam.py), over
    :func:`adam_update`:

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
        lrs = {k: self.lr[k] if isinstance(self.lr, dict) else self.lr for k in self.params}
        self.params, self.exp_avg, self.exp_avg_sq = adam_update(
            self.params, {k: grads[k] for k in self.params}, self.exp_avg, self.exp_avg_sq,
            lrs, self.b1, self.b2, self.eps, visibility)
        return self.params
