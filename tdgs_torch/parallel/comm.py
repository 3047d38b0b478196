"""Collectives of the gaussian-sharded path (port of ``tdgs/parallel/
comm.py``: ``world_size``, ``world_rank``, ``all_gather``, ``all_to_all``,
``all_reduce_sum`` and the two list variants, :23-68).

The JAX package calls ``jax.lax`` collectives inside one ``shard_map``,
where the compiler differentiates them. Here every rank is a process and
the collectives are ``torch.distributed`` calls on a process group
(``None``: the whole world). Those that carry a gradient are
``torch.autograd.Function``s whose backward is the transposed collective:

- ``all_to_all``: the same exchange with the split and concat axes
  swapped, so each gaussian's gradient goes back to its owner without an
  all-reduce (``tdgs/parallel/sharded_render.py:87-90``);
- ``all_gather``: a reduce-scatter, written as an ``all_to_all`` and a sum
  over the source axis (gloo has no reduce-scatter);
- ``all_reduce_sum``: an all-reduce of the cotangent.

``replicated`` is the transpose the JAX compiler inserts for an input
replicated over a mesh axis: the identity, whose backward sums the
cotangent over that axis.

Every rank must call the same collectives in the same order, forward and
backward. ``EXCHANGED`` counts the bytes this rank hands to collectives
(each call's input tensor) and the calls, since ``reset_exchanged()``.
Tensors on a card go to the collective as they are. gloo takes CUDA
tensors for every collective called here (all_gather, all_to_all_single,
all_reduce; checked with torch 2.11 and CUDA 12.8 on an NVIDIA H100) and
copies them through host memory itself; NCCL moves them card to card. So
this module stages nothing through pinned memory of its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# bytes handed to collectives and calls made, since reset_exchanged()
EXCHANGED: Dict[str, int] = {"bytes": 0, "calls": 0}


def reset_exchanged() -> None:
    EXCHANGED["bytes"] = 0
    EXCHANGED["calls"] = 0


def _count(x: torch.Tensor) -> None:
    EXCHANGED["bytes"] += x.numel() * x.element_size()
    EXCHANGED["calls"] += 1


def world_size(group: Group = None) -> int:
    return dist.get_world_size(group)


def world_rank(group: Group = None) -> int:
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# the collectives themselves (no autograd)
# ---------------------------------------------------------------------------


def _gather0(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0, in rank order."""
    D = world_size(group)
    x = x.contiguous()
    _count(x)
    parts = [torch.empty_like(x) for _ in range(D)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def _exchange(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into D blocks along ``split_axis``, block
    j to rank j; the blocks received joined along ``concat_axis`` in the
    order of their source ranks."""
    D = world_size(group)
    nd = x.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    S = x.shape[split_axis]
    if S % D:
        raise ValueError(f"all_to_all: axis {split_axis} of size {S} does not split over {D}")
    moved = x.movedim(split_axis, 0)
    send = moved.reshape((D, S // D) + tuple(moved.shape[1:])).contiguous()
    _count(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # [D(src), S/D, rest] → blocks shaped like x with S/D on split_axis
    blocks = recv.movedim(1, split_axis + 1)
    # source axis just before concat_axis, then merged into it
    out = blocks.movedim(0, concat_axis)
    shape = list(blocks.shape[1:])
    shape[concat_axis] *= D
    return out.reshape(shape)


def _reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    _count(out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        D = world_size(ctx.group)
        mine = _exchange(g.contiguous(), ctx.group, 0, 0)  # [D·n]: my block from each rank
        return mine.reshape((D, -1) + tuple(g.shape[1:])).sum(0), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _exchange(g.contiguous(), group, concat_axis, split_axis), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_gather(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 (``jax.lax.all_gather``
    tiled). Backward: the reduce-scatter of the cotangent."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group = None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Exchange equal blocks between ranks (``jax.lax.all_to_all`` tiled):
    block j of ``split_axis`` goes to rank j, and the blocks received are
    joined along ``concat_axis`` in rank order. Backward: the exchange with
    the axes swapped."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def all_reduce_sum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks (``jax.lax.psum``). Backward: the sum
    of the cotangents."""
    return _AllReduceSum.apply(x, group)


def replicated(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``x``, held alike by every rank of ``group``; backward sums the
    cotangent over the group, so each rank gets the whole gradient."""
    return _Replicated.apply(x, group)


def all_gather_tensor_list(tensors: Sequence[torch.Tensor], group: Group = None
                           ) -> List[torch.Tensor]:
    return [all_gather(t, group) for t in tensors]


def all_to_all_tensor_list(tensors: Sequence[torch.Tensor], group: Group = None,
                           split_axis: int = 0, concat_axis: int = 0) -> List[torch.Tensor]:
    return [all_to_all(t, group, split_axis, concat_axis) for t in tensors]
