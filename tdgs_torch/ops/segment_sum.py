"""Sorted segment sum: the gather-VJP without float atomics (port of
``tdgs/ops/segment_sum_pallas.py``).

The training path gathers per-entry feature rows by the tile-sorted
``flatten_ids``. The VJP of that gather sums each gaussian's entry rows.
As in the JAX package it is one sort of the ids and a segmented reduction
over the sorted stream, so the sums are deterministic. The sort is PyTorch's
stable ``torch.sort``. The reduction runs in a hand-written CUDA kernel
(``tdgs_torch/csrc/segment_sum.cu``) for CUDA tensors and in the plain
PyTorch version below for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tdgs_torch.ops import _build

KERNEL = "segment_sum"
MAX_COLUMNS = 64


def segment_rows_sum_plain(
    rows: torch.Tensor,  # [R, F] float32, stream order
    perm: torch.Tensor,  # [E] int64: a stable sort's permutation into rows
    sids: torch.Tensor,  # [E] sorted ids; ids outside [0, n_rows) are ignored
    n_rows: int,
    abs_cols: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version: ``out[g] = Σ rows[perm[e]]`` over sorted
    positions e with ``sids[e] == g``, as differences of a float64 running
    sum at the segment bounds; with ``abs_cols`` two more columns hold the
    same sums of ``|rows[:, 0:2]|``. Returns [n_rows, F (+2)] float32."""
    sorted_rows = rows[perm].to(torch.float64)
    if abs_cols:
        sorted_rows = torch.cat([sorted_rows, sorted_rows[:, :2].abs()], dim=1)
    run = torch.cat([sorted_rows.new_zeros((1, sorted_rows.shape[1])),
                     torch.cumsum(sorted_rows, dim=0)])
    bounds = torch.searchsorted(
        sids.to(torch.int64),
        torch.arange(n_rows + 1, dtype=torch.int64, device=rows.device),
    )
    return (run[bounds[1:]] - run[bounds[:-1]]).to(torch.float32)


@functools.cache
def _load_kernel():
    lib = _build.load(KERNEL)
    fn = lib.tdgs_segment_sum
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def segment_rows_sum(
    rows: torch.Tensor,  # [R, F] float32, read only through perm
    perm: torch.Tensor,  # [E] int64 positions into rows
    sids: torch.Tensor,  # [E] int32 sorted
    n_rows: int,
    abs_cols: bool = False,
) -> torch.Tensor:
    """Per-row sums of the sorted segments → [n_rows, F (+2)]. ``perm`` may
    name fewer rows than ``rows`` holds (a sort of the valid slots only).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take the
    plain version."""
    device = rows.device
    if device.type == "cpu":
        return segment_rows_sum_plain(rows, perm, sids, n_rows, abs_cols)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    F = rows.shape[1]
    E = sids.shape[0]
    for name, t, dtype in (("rows", rows, torch.float32), ("perm", perm, torch.int64),
                           ("sids", sids, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: expected device {device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if rows.dim() != 2 or perm.shape != (E,) or sids.shape != (E,):
        raise ValueError(f"rows {tuple(rows.shape)} / perm {tuple(perm.shape)} / "
                         f"sids {tuple(sids.shape)}")
    if not 1 <= F <= MAX_COLUMNS or (abs_cols and F < 2):
        raise ValueError(f"rows: 1..{MAX_COLUMNS} columns supported, got {F}")
    if E >= 2**31:
        raise ValueError(f"{E} entries: the kernel takes fewer than 2^31")
    if rows.data_ptr() % 16:  # the kernel reads rows in aligned 16-byte chunks
        rows = rows.clone()
    out = torch.empty((n_rows, F + (2 if abs_cols else 0)), dtype=torch.float32,
                      device=device)
    fn = _load_kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(rows.data_ptr(), perm.data_ptr(), sids.data_ptr(), out.data_ptr(), E,
                 n_rows, F, int(abs_cols), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with cudaError_t {err}")
    _build.count_launch(KERNEL)
    return out


def sort_ids(ids: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None):
    """(sorted ids int32, permutation int64) of a stable sort. Slots at or
    past ``n_valid`` (a 0-d device tensor: stream padding) are given an id
    past every row, so they sort last and fall in no segment; this needs no
    host sync. Slots where ``mask`` is False (invalid slots inside the
    stream) are left out before the sort: only the valid ids are sorted,
    and the permutation names their positions in ``ids``. Finding them
    waits for the device once."""
    ids = ids.to(torch.int32)
    if n_valid is not None:
        pos = torch.arange(ids.shape[0], device=ids.device)
        ids = torch.where(pos < n_valid, ids, torch.iinfo(torch.int32).max)
    if mask is not None:
        keep = torch.nonzero(mask.reshape(-1)).reshape(-1)
        sids, order = torch.sort(ids[keep], stable=True)
        return sids.contiguous(), keep[order].contiguous()
    sids, perm = torch.sort(ids, stable=True)
    return sids.contiguous(), perm.contiguous()


class _GatherRowsSegsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, ids, n_valid, abs_tap, mask):
        ctx.save_for_backward(ids, n_valid, mask)
        ctx.n_rows, ctx.F = feats.shape
        ctx.with_abs = abs_tap is not None
        return feats[ids.long()]

    @staticmethod
    def backward(ctx, v_rows):
        ids, n_valid, mask = ctx.saved_tensors
        sids, perm = sort_ids(ids, n_valid, mask)
        sums = segment_rows_sum(v_rows.contiguous(), perm, sids, ctx.n_rows,
                                abs_cols=ctx.with_abs)
        v_abs = sums[:, ctx.F:] if ctx.with_abs else None
        return sums[:, :ctx.F], None, None, v_abs, None


def gather_rows_segsum(
    feats: torch.Tensor,  # [n_rows, F]
    ids: torch.Tensor,  # [E] int32
    n_valid: Optional[torch.Tensor] = None,  # 0-d: slots at or past it are padding
    abs_tap: Optional[torch.Tensor] = None,  # [n_rows, 2] zeros
    mask: Optional[torch.Tensor] = None,  # [E] bool: False slots are padding
) -> torch.Tensor:
    """``feats[ids]`` whose VJP is a stable sort of ``ids`` and the segment
    sum above, in place of an atomic scatter-add. Slots at or past
    ``n_valid``, and slots where ``mask`` is False, send no gradient back
    (their ids may be anything in range). The gradient of ``abs_tap`` is
    the per-row sum of |cotangent[:, 0:2]| (the AbsGS signal of the JAX
    package's ``absgrad_tap``, taken after the gather)."""
    return _GatherRowsSegsum.apply(feats, ids, n_valid, abs_tap, mask)
